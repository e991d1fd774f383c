// The expression VM: one launch runs a whole compiled instruction program
// (halo2_tpu_torch/plonkish/cuda_vm.py:compile_program) over every row.
//
// No Pallas counterpart: this replaces the reference's VM,
// halo2_tpu/plonkish/evaluator.py:_run_program, a lax.scan over the
// instruction table inside one jitted program, which the prover's quotient
// (the flagship's 771 instructions), the MockProver's gate checks and its
// lookup evaluation run.
//
// The program: queries (a column at a rotation), constants, and instructions
// (op, src1, src2, dst) with op 0 = add, 1 = multiply (Montgomery), 2 = negate
// (src1 only).  A source is tag | index << 2 with tag 0 = query, 1 = constant,
// 2 = register; dst is a register.  The host allocates registers by liveness
// (a register is free after the last instruction that reads it), so the
// flagship's program needs 16 where the reference's scan buffer holds every
// intermediate.  Outputs are sources, copied to (O, 16, n) after the last
// instruction.
//
// Queries: one Query entry per call, uploaded in one copy: the address of
// the column's limb 0 at row 0, its limb and row strides in elements (a row
// stride of 0 is one broadcast element: a challenge handed over as an
// expanded view), and the row shift.  Row i reads row (i + shift) mod n,
// shift = rotation * rot_scale mod n, as jnp.roll(column, -shift) does in the
// reference, without the rolled copy.  A launch may cover a row range only
// (the sharded prover's block of the quotient): thread row i of the launch
// is domain row row0 + i and writes output column i, while the queries still
// wrap at the full n.
//
// Design: a block holds 64 rows (32 when the registers need it) and four
// warps, streams, per 32 rows: the host (cuda_vm._schedule) splits each row's
// program into per-stream instruction runs and phases, so that a result one
// stream reads from another was made in an earlier phase; a barrier ends
// each phase.  Thread (s, t) runs stream s of row t, neighbouring threads on
// neighbouring rows, so every limb load of a query is coalesced and every
// branch on an instruction is uniform in a warp.  The instruction, offset,
// constant and query tables are read through the read-only path (the next
// instruction's load overlaps the current one).  A block's registers live in
// its dynamic shared memory, laid out [register][8 words][rows of the block]
// with the row fastest: thread t touches word t of each 32-word run, so a
// warp's access is one conflict-free shared-memory transaction and no
// register value leaves the SM.  Both operands are loaded before the result
// is stored, so an instruction's dst may be one of its own sources; the
// host's register allocation keeps a register from being reused before
// every stream that reads its value has read it.  The wrapper
// (cuda_vm.rows_per_block) takes 64 rows a block, or 32 when 64 rows of the
// program's registers would not fit the 227 KB a block may hold; the
// flagship's 27 registers take 54 KB for 64 rows, so an SM holds four blocks,
// 32 warps (one thread a row held eight).  The last block may be partial (the
// MockProver runs the VM at 2^7 to 2^11 rows): its extra threads skip the
// instructions but keep to the barriers.
//
// What bounds it on an H100: each multiply is 272 32-bit multiply-adds, and
// each query read 64 bytes a row; the flagship's 379 multiplies over 2^15
// rows bound it at ~0.20 ms by the integer units, its bytes (127 query
// columns, one output) at ~0.08 ms.  Measured on one NVIDIA H100 80GB HBM3
// at 700 W (PERF.md): registers in global scratch, one thread a row, 0.64 ms
// (31 % of the bound); in shared memory, one thread a row, 0.66-0.70 ms, so
// register traffic through L2 was not what bounded it; four streams a row,
// 0.46 ms (44 %).  A warp runs one instruction at a time, so the two carry
// chains of a product are all it has to hide the multiply-adds' latency, and
// shared memory and the register file cap an SM at 32 warps: eight streams
// need 46 registers (two blocks an SM, no faster), and running two
// independent products at once took 78 thread registers (slower).
//
// Templates on the arithmetic (arith.cuh): arith 0 = CcArith (p < 2^254: the
// BN254 prove and flagship MockProver), 1 = WideArith (Pasta Fp).

#include "arith.cuh"

using namespace h2t;

namespace {

constexpr int MAX_ROWS = 64;     // rows a block, most; 512 blocks at n = 2^15
constexpr int MAX_STREAMS = 4;   // warps (streams) a row, most
constexpr int MAX_THREADS = MAX_ROWS * MAX_STREAMS;
constexpr int SMEM_MAX = 232448;  // the 227 KB of shared memory one block may hold
constexpr int SMEM_DEFAULT = 48 * 1024;  // above this, only after cudaFuncSetAttribute
constexpr int OP_ADD = 0, OP_MUL = 1, OP_NEG = 2;
constexpr int SRC_QUERY = 0, SRC_CONST = 1, SRC_REG = 2;

// One query, as halo2_tpu_torch/plonkish/cuda_vm.py packs it: 4 int64.
struct Query {
  long long base;         // device address of limb 0, row 0
  long long limb_stride;  // elements between limbs
  long long row_stride;   // elements between rows; 0 for one broadcast element
  long long shift;        // 0 <= shift < n
};

// The 8 words of source ``src`` at ``row``; ``regs`` is this thread's column
// of the block's registers (word k of register r at regs[(r * 8 + k) * rows]).
__device__ __forceinline__ void fetch(int src, const Query* __restrict__ queries,
                                      const uint32_t* __restrict__ consts, const uint32_t* regs,
                                      int rows, size_t n, size_t row, uint32_t w[WORDS]) {
  const int tag = src & 3;
  const int idx = src >> 2;
  if (tag == SRC_REG) {
    const uint32_t* r = regs + idx * WORDS * rows;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = r[k * rows];
  } else if (tag == SRC_CONST) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = __ldg(consts + idx * WORDS + k);
  } else {
    const longlong2* q = reinterpret_cast<const longlong2*>(queries + idx);
    const longlong2 base_limb = __ldg(q), stride_shift = __ldg(q + 1);
    const long long limb = base_limb.y;
    size_t at = row + static_cast<size_t>(stride_shift.y);
    if (at >= n) at -= n;
    const uint32_t* base =
        reinterpret_cast<const uint32_t*>(base_limb.x) + at * static_cast<size_t>(stride_shift.x);
#pragma unroll
    for (int k = 0; k < WORDS; ++k)
      w[k] = __ldg(base + 2 * k * limb) | (__ldg(base + (2 * k + 1) * limb) << 16);
  }
}

// Thread (s, t) of a block of ``streams`` x ``rows`` threads runs stream s
// of row t: warps never mix streams, so every branch on the instruction is
// uniform.  Threads past the last row skip the instructions but not the
// barriers.
template <class A>
__global__ void __launch_bounds__(MAX_THREADS)
vm_eval_kernel(const Query* __restrict__ queries, const uint32_t* __restrict__ consts,
               const int4* __restrict__ instrs, const int* __restrict__ offsets, int phases, int streams,
               const int* __restrict__ outputs, int n_outputs, uint32_t* __restrict__ out, int n,
               int row0, int count, Modulus M) {
  extern __shared__ uint32_t smem[];  // [num_regs][WORDS][rows]
  const int rows = blockDim.x / streams;
  const int stream = threadIdx.x / rows;
  const int t = threadIdx.x - stream * rows;
  const size_t i = static_cast<size_t>(blockIdx.x) * rows + t;  // output column
  const size_t row = static_cast<size_t>(row0) + i;              // domain row, < n when live
  const size_t total = static_cast<size_t>(n);
  const size_t width = static_cast<size_t>(count);
  const bool live = i < width;
  uint32_t* regs = smem + t;
  for (int p = 0; p < phases; ++p) {
    const int begin = __ldg(offsets + p * streams + stream);
    const int end = live ? __ldg(offsets + p * streams + stream + 1) : begin;
    int4 next = begin < end ? __ldg(instrs + begin) : make_int4(0, 0, 0, 0);
    for (int i = begin; i < end; ++i) {
      const int4 ins = next;  // the next instruction's load overlaps this one
      if (i + 1 < end) next = __ldg(instrs + i + 1);
      uint32_t a[WORDS], b[WORDS], r[WORDS];
      fetch(ins.y, queries, consts, regs, rows, total, row, a);
      if (ins.x == OP_NEG) {
#pragma unroll
        for (int k = 0; k < WORDS; ++k) b[k] = 0;
        A::sub(b, a, M, r);
      } else {
        fetch(ins.z, queries, consts, regs, rows, total, row, b);
        if (ins.x == OP_MUL)
          A::mul(a, b, M, r);
        else
          A::add(a, b, M, r);
      }
      uint32_t* dst = regs + ins.w * WORDS * rows;
#pragma unroll
      for (int k = 0; k < WORDS; ++k) dst[k * rows] = r[k];
    }
    if (streams > 1) __syncthreads();
  }
  if (!live) return;
  for (int o = stream; o < n_outputs; o += streams) {
    uint32_t r[WORDS];
    fetch(__ldg(outputs + o), queries, consts, regs, rows, total, row, r);
    store_elem(out + static_cast<size_t>(o) * 2 * WORDS * width, width, i, r);
  }
}

template <class A>
int launch(const void* queries, const void* consts, const void* instrs, const void* offsets, int phases,
           int streams, const void* outputs, int n_outputs, int num_regs, int rows, void* out, int n,
           int row0, int count, const Modulus& M, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(num_regs) * WORDS * sizeof(uint32_t) * rows;
  if (rows < 32 || rows > MAX_ROWS || rows % 32 || streams < 1 || streams > MAX_STREAMS || phases < 0 ||
      num_regs < 0 || smem > SMEM_MAX || row0 < 0 || count <= 0 || count > n - row0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t rc =
        cudaFuncSetAttribute(vm_eval_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  vm_eval_kernel<A><<<(count + rows - 1) / rows, rows * streams, smem, stream>>>(
      static_cast<const Query*>(queries), static_cast<const uint32_t*>(consts),
      static_cast<const int4*>(instrs), static_cast<const int*>(offsets), phases, streams,
      static_cast<const int*>(outputs), n_outputs, static_cast<uint32_t*>(out), n, row0, count, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the program over the rows row0 .. row0 + count - 1 of n (every row:
// row0 = 0, count = n).  queries: (Q, 4) int64 Query entries;
// consts: (C, 8) Montgomery words; instrs: (I, 4) int32, 16-byte aligned,
// phase by phase, stream by stream; offsets: (phases * streams + 1,) int32,
// stream s of phase p running instrs[offsets[p * streams + s] ..
// offsets[p * streams + s + 1]); outputs: (O,) int32 sources; num_regs: the
// program's registers; rows: rows a block (a multiple of 32, at most 64,
// num_regs * 32 * rows bytes at most 227 KB); out: (O, 16, count).  arith:
// 0 = CcArith (p < 2^254), 1 = WideArith.
extern "C" int h2t_vm_eval(const void* queries, const void* consts, const void* instrs, const void* offsets,
                           int phases, int streams, const void* outputs, int n_outputs, int num_regs, int rows,
                           void* out, int n, int row0, int count, const void* modulus, int arith,
                           void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith == 0)
    return launch<CcArith>(queries, consts, instrs, offsets, phases, streams, outputs, n_outputs, num_regs,
                           rows, out, n, row0, count, M, s);
  if (arith == 1)
    return launch<WideArith>(queries, consts, instrs, offsets, phases, streams, outputs, n_outputs, num_regs,
                             rows, out, n, row0, count, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

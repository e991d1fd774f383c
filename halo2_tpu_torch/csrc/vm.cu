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
// reference, without the rolled copy.
//
// Design (simple first): one thread per row, neighbouring threads on
// neighbouring rows, so every limb load of a query and every word of a
// register is coalesced.  The instruction, constant and query tables are
// read through the read-only path: every thread of a warp reads the same
// entry.  Both operands are loaded before the result is stored, so an
// instruction's dst may be one of its own sources.  Registers live in global
// scratch, (R, 8 words, n) with rows fastest: 16 x 32 B x 2^15 = 16.8 MB at
// the flagship, inside the 50 MB L2.
//
// What bounds it on an H100: each multiply is 272 32-bit multiply-adds, and
// each query read 64 bytes a row; the flagship's 379 multiplies over 2^15
// rows bound it at ~0.20 ms by the integer units, its bytes (127 query
// columns, one output) at ~0.08 ms.  The register traffic is this design's
// own cost: one H100 ran the flagship's program in 0.64 ms, 31 % of the
// bound (PERF.md).  Holding registers in shared memory or in registers,
// warp-level tiling and fusing the vanishing multiply are later work.
//
// Templates on the arithmetic (arith.cuh): arith 0 = CcArith (p < 2^254: the
// BN254 prove and flagship MockProver), 1 = WideArith (Pasta Fp).

#include "arith.cuh"

using namespace h2t;

namespace {

constexpr int THREADS = 64;  // 512 blocks at n = 2^15, ~4 an SM
constexpr int OP_ADD = 0, OP_MUL = 1, OP_NEG = 2;
constexpr int SRC_QUERY = 0, SRC_CONST = 1, SRC_REG = 2;

// One query, as halo2_tpu_torch/plonkish/cuda_vm.py packs it: 4 int64.
struct Query {
  long long base;         // device address of limb 0, row 0
  long long limb_stride;  // elements between limbs
  long long row_stride;   // elements between rows; 0 for one broadcast element
  long long shift;        // 0 <= shift < n
};

// The 8 words of source ``src`` at ``row``.  Registers are written by this
// kernel, so they are read through the ordinary (coherent) path.
__device__ __forceinline__ void fetch(int src, const Query* __restrict__ queries,
                                      const uint32_t* __restrict__ consts, const uint32_t* regs,
                                      size_t n, size_t row, uint32_t w[WORDS]) {
  const int tag = src & 3;
  const size_t idx = static_cast<size_t>(src >> 2);
  if (tag == SRC_REG) {
    const uint32_t* r = regs + idx * WORDS * n + row;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = r[k * n];
  } else if (tag == SRC_CONST) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = __ldg(consts + idx * WORDS + k);
  } else {
    const Query* q = queries + idx;
    const long long limb = __ldg(&q->limb_stride);
    size_t at = row + static_cast<size_t>(__ldg(&q->shift));
    if (at >= n) at -= n;
    const uint32_t* base =
        reinterpret_cast<const uint32_t*>(__ldg(&q->base)) + at * static_cast<size_t>(__ldg(&q->row_stride));
#pragma unroll
    for (int k = 0; k < WORDS; ++k)
      w[k] = __ldg(base + 2 * k * limb) | (__ldg(base + (2 * k + 1) * limb) << 16);
  }
}

template <class A>
__global__ void __launch_bounds__(THREADS)
vm_eval_kernel(const Query* __restrict__ queries, const uint32_t* __restrict__ consts,
               const int4* __restrict__ instrs, int n_instrs, const int* __restrict__ outputs,
               int n_outputs, uint32_t* regs, uint32_t* __restrict__ out, int n, Modulus M) {
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t rows = static_cast<size_t>(n);
  if (row >= rows) return;
  for (int i = 0; i < n_instrs; ++i) {
    const int4 ins = __ldg(instrs + i);
    uint32_t a[WORDS], b[WORDS], r[WORDS];
    fetch(ins.y, queries, consts, regs, rows, row, a);
    if (ins.x == OP_NEG) {
#pragma unroll
      for (int k = 0; k < WORDS; ++k) b[k] = 0;
      A::sub(b, a, M, r);
    } else {
      fetch(ins.z, queries, consts, regs, rows, row, b);
      if (ins.x == OP_MUL)
        A::mul(a, b, M, r);
      else
        A::add(a, b, M, r);
    }
    uint32_t* dst = regs + static_cast<size_t>(ins.w) * WORDS * rows + row;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) dst[k * rows] = r[k];
  }
  for (int o = 0; o < n_outputs; ++o) {
    uint32_t r[WORDS];
    fetch(__ldg(outputs + o), queries, consts, regs, rows, row, r);
    store_elem(out + static_cast<size_t>(o) * 2 * WORDS * rows, rows, row, r);
  }
}

template <class A>
void launch(const void* queries, const void* consts, const void* instrs, int n_instrs,
            const void* outputs, int n_outputs, void* regs, void* out, int n, const Modulus& M,
            cudaStream_t stream) {
  vm_eval_kernel<A><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const Query*>(queries), static_cast<const uint32_t*>(consts),
      static_cast<const int4*>(instrs), n_instrs, static_cast<const int*>(outputs), n_outputs,
      static_cast<uint32_t*>(regs), static_cast<uint32_t*>(out), n, M);
}

}  // namespace

// Runs the program over n rows.  queries: (Q, 4) int64 Query entries;
// consts: (C, 8) Montgomery words; instrs: (I, 4) int32, 16-byte aligned;
// outputs: (O,) int32 sources; regs: (R, 8, n) scratch; out: (O, 16, n).
// arith: 0 = CcArith (p < 2^254), 1 = WideArith.
extern "C" int h2t_vm_eval(const void* queries, const void* consts, const void* instrs, int n_instrs,
                           const void* outputs, int n_outputs, void* regs, void* out, int n,
                           const void* modulus, int arith, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith == 0) {
    launch<CcArith>(queries, consts, instrs, n_instrs, outputs, n_outputs, regs, out, n, M, s);
  } else if (arith == 1) {
    launch<WideArith>(queries, consts, instrs, n_instrs, outputs, n_outputs, regs, out, n, M, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// poseidon_hash: the batched Poseidon sponge in one launch, a thread a lane.
//
// Hash mode: m lanes of ConstantLength<L> messages, (L, 16, m) Montgomery
// limbs -> (16, m) digests.  The state starts at (0, .., 0, L 2^64) (the
// capacity word, passed in), then ceil(L / rate) times: the next rate message
// words added into words 0 .. rate - 1 (zeros past L) and a permutation.
// Permute mode: (W, 16, m) states -> (W, 16, m), one permutation.  A
// permutation is r_f full rounds, r_p partial rounds and r_f full rounds;
// each round adds its W round constants, applies the x^5 S-box (two squares
// and a product) to every word (full) or word 0 (partial), and multiplies
// by the W x W MDS matrix.
//
// Replaces the reference's three lax.scans over the rounds
// (halo2_tpu/poseidon/primitives.py:163-224, permute_device and
// hash_device), which XLA compiles into one device program; the port ran
// each round as field-op launches (a MySpec(5, 4) permutation ~3,500 of
// mont_mul, mont_sqr and mod_add, each sending the 64 MB state word of 2^20
// lanes through device memory).  Every value canonical and the sums mod p
// exact, so the output equals the plain versions
// (poseidon/primitives.py: permute_device_plain, hash_device_plain) limb
// for limb.
//
// The round schedule: the full rounds as the spec states them (W round
// constants, W S-boxes, the dense W x W MDS product), and the r_p partial
// rounds in their equivalent sparse form (Grassi et al., Poseidon, USENIX
// Security 2021, Appendix B; the authors' calc_equivalent_constants and
// calc_equivalent_matrices), computed exactly on the host
// (poseidon/cuda_sponge.py: sparse_form): before the first partial round
// one vector constant c_hat and one dense matrix (the edge, B_0), then a
// partial round is one S-box on word 0, one scalar constant k_q added to
// word 0, and a sparse matrix: a first row (new x0 = sum_j row_j x_j, W
// products) and a first column (new x_i = x_i + col_i x0, W - 1 products).
// A MySpec(5, 4) permutation takes 25 + 56 x 9 + 8 x 25 = 729 MDS products
// where the dense form took 64 x 25 = 1,600.
//
// What bounds it: integer multiplies.  A MySpec(5, 4) permutation is 96
// S-boxes and 729 MDS products, 265,872 IMADs (CcArith), against (L + 1) x
// 64 bytes of message and digest a lane: ~16.7 ms at 2^20 lanes at the
// H100's IMAD rate, ~0.1 ms of bytes.  So the state (W x 8 words) and the
// MDS row sums stay in registers for the whole sponge, and only the
// messages and the result touch device memory.  The code stays small (an
// unrolled round of W = 5 would be ~40 products, ~16K instructions, past
// the instruction cache): the rounds, the S-box words, the MDS rows and the
// sparse matrix's entries are loops that are not unrolled, each step on
// word 0 of the state (or the newest row sum) followed by a rotation of the
// W words in registers, so a full round's code is one add, one S-box and
// one row of W products, and a partial round's one S-box and two products
// (an entry of the row, an entry of the column).
//
// Constants: one table of 8-word Montgomery elements
// (poseidon/cuda_sponge.py: constants_words, table_layout), packed once per
// field, spec and device, in this order (entry offsets):
//   0                the full rounds' constants: full round f (the first
//                    r_f, then the last r_f) word i at f W + i;
//   RC = 2 r_f W     c_hat, W entries;
//   KS = RC + W      k_q, r_p entries (k_(r_p - 1) = 0);
//   MDS = KS + r_p   the MDS matrix, (i, j) at MDS + i W + j;
//   EDGE = MDS + W^2 the edge matrix B_0, (i, j) at EDGE + i W + j;
//   SP = EDGE + W^2  partial round q's sparse matrix at SP + q (2 W - 1):
//                    its first row (W), then its first column below the
//                    corner (W - 1).
// 655 entries (20,960 bytes) for W = 5, 381 (12,192 bytes) for W = 3.
// Every thread of a warp reads the same entry at the same time, so each
// read is one request the warp shares.  A block copies the table once into
// shared memory (bulk.cuh, Hopper's bulk copy) and reads it there: on one
// H100 that was 1-2 % faster at 2^20 lanes and 7-23 % at 2^11-2^16 than
// reading it through the read-only path (scripts/table_variants.cu holds
// that variant, scripts/table_probe.py times it; PERF.md).
//
// Widths: 3 (P128Pow5T3) and 5 (MySpec(5, 4)), each for both
// arithmetics (arith.cuh: CcArith for BN254 Fr, WideArith for the Pasta
// fields); any other width is refused.  Three 128-thread blocks an SM (at
// most 168 registers).

#include "arith.cuh"
#include "bulk.cuh"

using namespace h2t;

namespace {

constexpr int SPONGE_THREADS = 128;
constexpr int SPONGE_MIN_BLOCKS = 3;

// The table's size in bytes (the layout above).
__host__ __device__ constexpr uint32_t table_bytes(int W, int r_f, int r_p) {
  return static_cast<uint32_t>(2 * r_f * W + W + r_p + 2 * W * W + r_p * (2 * W - 1)) * 32u;
}

// The capacity word, by value.
struct Word8 {
  uint32_t w[WORDS];
};

__device__ __forceinline__ void load_const(const uint4* __restrict__ tab, int e, uint32_t v[WORDS]) {
  const uint4 lo = tab[2 * e], hi = tab[2 * e + 1];
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = lo.z;
  v[3] = lo.w;
  v[4] = hi.x;
  v[5] = hi.y;
  v[6] = hi.z;
  v[7] = hi.w;
}

template <int W>
__device__ __forceinline__ void rotate(uint32_t st[W][WORDS]) {  // word i + 1 to i, word 0 to W - 1
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const uint32_t first = st[0][k];
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) st[i][k] = st[i + 1][k];
    st[W - 1][k] = first;
  }
}

// x = x^5: x^2, x^4, then x^4 x.
template <class A>
__device__ __forceinline__ void sbox(uint32_t x[WORDS], const Modulus& M) {
  uint32_t t[WORDS];
  A::sqr(x, M, t);
  A::sqr(t, M, t);
  A::mul(t, x, M, x);
}

// st = mat st for the dense W x W matrix at entry e (row i at e + i W): row
// i's sum, then the sums rotate in, so that after W rows sums[i] is row i.
template <int W, class A>
__device__ __forceinline__ void dense(uint32_t st[W][WORDS], const uint4* __restrict__ tab, int e,
                                      const Modulus& M) {
  uint32_t sums[W][WORDS] = {};
#pragma unroll 1
  for (int i = 0; i < W; ++i) {
    uint32_t c[WORDS], t[WORDS];
    load_const(tab, e + i * W, c);
    A::mul(st[0], c, M, sums[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) {
      load_const(tab, e + i * W + j, c);
      A::mul(st[j], c, M, t);
      A::add(sums[0], t, M, sums[0]);
    }
    rotate<W>(sums);
  }
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int k = 0; k < WORDS; ++k) st[i][k] = sums[i][k];
}

// st += the W constants at entry e, word by word (word i is at 0); with
// sbox, each word then through the S-box.
template <int W, class A>
__device__ __forceinline__ void add_consts(uint32_t st[W][WORDS], const uint4* __restrict__ tab, int e, bool sbox_all,
                                           const Modulus& M) {
#pragma unroll 1
  for (int i = 0; i < W; ++i) {
    uint32_t c[WORDS];
    load_const(tab, e + i, c);
    A::add(st[0], c, M, st[0]);
    if (sbox_all) sbox<A>(st[0], M);
    rotate<W>(st);
  }
}

template <int W, class A>
__device__ __forceinline__ void permute(uint32_t st[W][WORDS], const uint4* __restrict__ tab, int r_f,
                                        int r_p, const Modulus& M) {
  const int ks = 2 * r_f * W + W, mds = ks + r_p, edge = mds + W * W, sp = edge + W * W;
#pragma unroll 1
  for (int f = 0; f < 2 * r_f; ++f) {
    add_consts<W, A>(st, tab, f * W, true, M);
    dense<W, A>(st, tab, mds, M);
    if (f + 1 != r_f) continue;
    // the partial block: c_hat and the edge matrix, then the r_p sparse rounds
    add_consts<W, A>(st, tab, 2 * r_f * W, false, M);
    dense<W, A>(st, tab, edge, M);
#pragma unroll 1
    for (int q = 0; q < r_p; ++q) {
      uint32_t c[WORDS], t[WORDS], x0[WORDS], row[WORDS];
      sbox<A>(st[0], M);
      load_const(tab, ks + q, c);
      A::add(st[0], c, M, st[0]);
      const int e = sp + q * (2 * W - 1);
#pragma unroll
      for (int k = 0; k < WORDS; ++k) x0[k] = st[0][k];
      load_const(tab, e, c);
      A::mul(x0, c, M, row);
      // word j at 0 after j rotations: its row product, then its column update
#pragma unroll 1
      for (int j = 1; j < W; ++j) {
        rotate<W>(st);
        load_const(tab, e + j, c);
        A::mul(st[0], c, M, t);
        A::add(row, t, M, row);
        load_const(tab, e + W + j - 1, c);
        A::mul(x0, c, M, t);
        A::add(st[0], t, M, st[0]);
      }
      rotate<W>(st);
#pragma unroll
      for (int k = 0; k < WORDS; ++k) st[0][k] = row[k];
    }
  }
}

template <int W, class A>
__global__ void __launch_bounds__(SPONGE_THREADS, SPONGE_MIN_BLOCKS)
poseidon_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int m, int n_msg, int hash,
                const uint4* __restrict__ table, int r_f, int r_p, Modulus M, Word8 cap) {
  extern __shared__ __align__(16) uint4 staged[];
  __shared__ uint64_t bar;
  bulk_stage(staged, table, table_bytes(W, r_f, r_p), &bar);
  const uint4* tab = staged;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  const size_t ld = static_cast<size_t>(m);
  constexpr int RATE = W - 1;
  uint32_t st[W][WORDS];
  if (hash) {
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int k = 0; k < WORDS; ++k) st[i][k] = i == RATE ? cap.w[k] : 0;
    const int chunks = (n_msg + RATE - 1) / RATE;
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int i = 0; i < RATE; ++i) {
        const int word = c * RATE + i;
        if (word < n_msg) {  // past L the padding is zero, and adding zero changes nothing
          uint32_t v[WORDS];
          load_elem(in + static_cast<size_t>(word) * 16 * ld, ld, idx, v);
          A::add(st[i], v, M, st[i]);
        }
      }
      permute<W, A>(st, tab, r_f, r_p, M);
    }
    store_elem(out, ld, idx, st[0]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) load_elem(in + static_cast<size_t>(i) * 16 * ld, ld, idx, st[i]);
    permute<W, A>(st, tab, r_f, r_p, M);
#pragma unroll
    for (int i = 0; i < W; ++i) store_elem(out + static_cast<size_t>(i) * 16 * ld, ld, idx, st[i]);
  }
}

template <int W, class A>
int launch(const void* in, void* out, int m, int n_msg, int hash, const void* table, int r_f, int r_p,
           const Modulus& M, const Word8& cap, cudaStream_t s) {
  const uint32_t smem = table_bytes(W, r_f, r_p);  // the staged table
  poseidon_kernel<W, A><<<(m + SPONGE_THREADS - 1) / SPONGE_THREADS, SPONGE_THREADS, smem, s>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), m, n_msg, hash,
      static_cast<const uint4*>(table), r_f, r_p, M, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hash 1: in (n_msg, 16, m) messages -> out (16, m); hash 0: in (W, 16, m)
// states -> out (W, 16, m).  table: the device constant table (16-byte
// aligned); modulus: 9 host words; cap: 8 host words (the capacity word in
// Montgomery form; read in hash mode); arith 0 = CcArith, 1 = WideArith.
extern "C" int h2t_poseidon_hash(const void* in, void* out, int m, int n_msg, int hash, int width, const void* table,
                                 int r_f, int r_p, const void* modulus, const void* cap, int arith, void* stream) {
  if (m <= 0 || n_msg < 0 || r_f < 1 || r_p < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  Word8 c;
  for (int k = 0; k < WORDS; ++k) c.w[k] = static_cast<const uint32_t*>(cap)[k];
  const auto s = static_cast<cudaStream_t>(stream);
  if (width == 3 && arith == 0) return launch<3, CcArith>(in, out, m, n_msg, hash, table, r_f, r_p, M, c, s);
  if (width == 3 && arith == 1) return launch<3, WideArith>(in, out, m, n_msg, hash, table, r_f, r_p, M, c, s);
  if (width == 5 && arith == 0) return launch<5, CcArith>(in, out, m, n_msg, hash, table, r_f, r_p, M, c, s);
  if (width == 5 && arith == 1) return launch<5, WideArith>(in, out, m, n_msg, hash, table, r_f, r_p, M, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Radix-2 NTT butterfly stages over bit-reversed limb arrays: one (16, n)
// column, or a batch of C columns (C, 16, n), column c at offset c * 16 * n.
//
// Replaces halo2_tpu/poly/pallas_ntt.py:_small_stages_kernel (every stage
// with half-size m <= 256, fused per 512-element tile) and
// _large_stage_kernel (one stage with m >= 512), composed by ntt_stages there
// and by halo2_tpu_torch/poly/cuda_ntt.py:ntt_stages here.  A stage with
// half-size m pairs element i0 = (k / m) * 2m + (k mod m) with i1 = i0 + m and
// writes a + b * w^(k mod m) to i0 and a - b * w^(k mod m) to i1.
//
// Twiddles: one (16, n - 1) limb table per (n, direction), shared by every
// column; the m twiddles of the stage with half-size m start at column m - 1.
//
// Arithmetic: both kernels are templates on it.  CcArith is field_cc.cuh's
// PTX carry chains (two IMAD.WIDE chains per row of the product), whose
// bounds hold only for p < 2^254: BN254's Fr and Fq.  WideArith is
// field.cuh's 64-bit-accumulator arithmetic, right for any p < 2^256: the
// 255-bit Pasta fields.  The Python wrapper picks one from the modulus
// (cuda_ntt._arith).  Both give the canonical values of the plain version.
//
// What bounds it on an H100: a butterfly is one Montgomery multiply (136
// IMAD.WIDE, 272 32-bit multiply-adds) plus a mod-add and a mod-sub, against
// 256 bytes of element traffic.  The nine fused small stages do eight
// multiplies per element pair per pass over memory, so they are bound by the
// integer units; a pass of r large stages does r, so six (2^15) are bound
// by the integer units and five or fewer by memory.
//
// ntt_small_stages: one block per 512-element tile of one column, grid
// (n / 512, C), so a batch of columns fills the card where one short column
// cannot (a 2^15 column is 64 tiles on 132 SMs).  Each of the 128 threads
// holds EPT = 4 consecutive elements: it loads them with vector loads, runs
// the stages m = 1, 2 in registers (skipping the multiply where the twiddle
// is w^0 = 1, which leaves a canonical b as it is), stores them to shared
// memory (16 KB, word-major, so that neighbouring elements fall on
// neighbouring banks) and runs the stages m = 4 .. 128 there, two
// butterflies per thread per stage.  The last stage (m = 256) pairs elements
// k and k + 256 and writes them straight to device memory.
//
// Below TILE (n = 2 .. 256 points: the sharded NTT's local transforms, whose
// four-step split gives 2^11 as 64 x 32 points and 2^15 as 256 x 128, where
// the reference runs its jnp stage ladder, halo2_tpu/poly/domain.py:78-91,
// compiled by XLA into one program), ntt_small_stages runs the whole
// transform: a block of 128 threads holds
// TILE / n whole columns, a TILE-element run of the batch (the last block
// fewer), in the same 16 KB of shared memory, and runs all log2(n) stages
// there (a template on log2 n), two butterflies per thread per stage.  It
// reads the columns in natural order, coalesced, and stores element i of a
// column to slot rev(i), so the caller gathers nothing; the result is
// stored coalesced from shared memory.  The twiddles are the n-point
// table's, whose stage m equals the TILE-point table's stage m.  What bounds
// it is what bounds the tile kernel (log2(n) - 1 multiplying stages per
// pass over memory): the integer units at 8 stages (n = 256), towards memory
// below.  One NVIDIA H100 80GB HBM3 at 700 W (PERF.md) ran 83 x 128
// transforms of 256 points in 0.25 ms (53 % of the bound) and 83 x 256 of
// 128 in 0.22 ms (51 %); 32 of 64 points (4 blocks) take 0.010 ms, the
// stages' chain of twiddle loads and products.
//
// ntt_large_stage: r = 1 .. 6 consecutive large stages m0, 2 m0, ..,
// m0 2^(r-1) in one pass over memory (cuda_ntt.large_stage_plan balances a
// transform's log2(n) - 9 large stages over ceil((log2(n) - 9) / 6) passes:
// one at 2^11 and 2^15, two at 2^20).  The elements those stages combine
// differ only in index bits log2(m0) .. log2(m0) + r - 1, so a group is 2^r
// elements at stride m0, and a block takes FUSE_T = 16 groups of consecutive
// low offsets: 16 x 2^r elements, 32 KB of shared memory at r = 6, every
// limb row read and written as 64-byte runs.  It loads them into shared
// memory (word-major, bit 4 of the slot flipped where bit 5 is set, so that
// a warp's two half-warps of butterflies fall on different banks at every
// stage), runs the r stages there with a barrier between stages, 256
// threads (fewer below r = 5) taking E / 2 butterflies a stage, and writes
// them back.  Grid (n / (16 x 2^r), C).  The twiddles come from the same
// table: stage m's butterfly at offset j of its 2m-block reads column
// (m - 1) + j.  At 2^20 the second pass's stages (m = 2^15 .. 2^19) read
// 31 x 2^15 distinct twiddles, 64 MB, more than the 50 MB L2: each is read
// once, counted in the bound (chip_smoke._ntt_work) rather than built from
// two smaller tables at one more product each.  What bounds a pass: at
// 2^15 x 83 the IMADs of its six stages (0.133 ms) above its bytes (0.105
// ms, one read and one write of the batch); at 2^20 the IMADs of the first
// pass (0.051 ms) and the bytes of the second (0.059).  One NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md) ran the 2^15 x 83 pass in 0.26 ms (51 % of
// its bound; six one-stage launches took 0.69) and the two 2^20 passes in
// 0.12 ms each (45 %; eleven launches took 0.69).  A lone column is short of
// blocks: 32 at 2^15, 0.022 ms.

#include "arith.cuh"

using namespace h2t;

namespace {

constexpr int TILE = 512;  // elements per block, small-stages kernel
constexpr int EPT = 4;      // elements per thread, small-stages kernel
constexpr int SMALL_THREADS = TILE / EPT;
constexpr int LIMBS = 2 * WORDS;
constexpr int LARGE_THREADS = 256;  // most threads a block, large stages
constexpr int FUSE_T = 16;          // consecutive low offsets a block, large stages
constexpr int MAX_STAGES = 6;       // large stages a pass: 32 KB of shared memory

// b *= twiddle (column idx of the table)
template <class A>
__device__ __forceinline__ void twiddle(uint32_t b[WORDS], const uint32_t* __restrict__ tw, int tw_ld,
                                        int idx, const Modulus& M) {
  uint32_t w[WORDS], t[WORDS];
  load_elem(tw, tw_ld, idx, w);
  A::mul(b, w, M, t);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) b[k] = t[k];
}

// (a, b) -> (a + b, a - b)
template <class A>
__device__ __forceinline__ void butterfly(uint32_t a[WORDS], uint32_t b[WORDS], const Modulus& M) {
  uint32_t u[WORDS], v[WORDS];
  A::add(a, b, M, u);
  A::sub(a, b, M, v);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = u[k];
    b[k] = v[k];
  }
}

template <class A>
__global__ void __launch_bounds__(SMALL_THREADS)
ntt_small_stages_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n,
                        const uint32_t* __restrict__ tw, Modulus M) {
  __shared__ __align__(16) uint32_t s[WORDS][TILE];
  const size_t col = static_cast<size_t>(blockIdx.y) * LIMBS * n;
  x += col;
  out += col;
  const int tw_ld = n - 1;
  const size_t base = static_cast<size_t>(blockIdx.x) * TILE;
  const int t = threadIdx.x;

  // this thread's EPT elements, one vector load per limb row
  uint32_t v[EPT][WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const uint4 lo = *reinterpret_cast<const uint4*>(x + (2 * k) * static_cast<size_t>(n) + base + EPT * t);
    const uint4 hi = *reinterpret_cast<const uint4*>(x + (2 * k + 1) * static_cast<size_t>(n) + base + EPT * t);
    v[0][k] = lo.x | (hi.x << 16);
    v[1][k] = lo.y | (hi.y << 16);
    v[2][k] = lo.z | (hi.z << 16);
    v[3][k] = lo.w | (hi.w << 16);
  }
  // stages m < EPT within the run (it starts at a multiple of 2m)
#pragma unroll
  for (int lm = 0; (1 << lm) < EPT; ++lm) {
    const int m = 1 << lm;
#pragma unroll
    for (int q = 0; q < EPT / 2; ++q) {
      const int j = q & (m - 1);
      const int i0 = 2 * (q - j) + j;
      if (j > 0) twiddle<A>(v[i0 + m], tw, tw_ld, (m - 1) + j, M);
      butterfly<A>(v[i0], v[i0 + m], M);
    }
  }
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    *reinterpret_cast<uint4*>(&s[k][EPT * t]) = make_uint4(v[0][k], v[1][k], v[2][k], v[3][k]);
  }
  __syncthreads();

  // stages m = EPT .. TILE / 4 through shared memory
  for (int m = EPT; m < TILE / 2; m <<= 1) {
#pragma unroll
    for (int h = 0; h < EPT / 2; ++h) {
      const int kb = t + h * SMALL_THREADS;
      const int j = kb & (m - 1);
      const int i0 = 2 * (kb - j) + j;
      const int i1 = i0 + m;
      uint32_t a[WORDS], b[WORDS];
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        a[k] = s[k][i0];
        b[k] = s[k][i1];
      }
      twiddle<A>(b, tw, tw_ld, (m - 1) + j, M);
      butterfly<A>(a, b, M);
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        s[k][i0] = a[k];
        s[k][i1] = b[k];
      }
    }
    __syncthreads();
  }

  // the stage m = TILE / 2: butterfly kb pairs kb and kb + 256, stored
  // straight to device memory (neighbouring threads, neighbouring elements)
#pragma unroll
  for (int h = 0; h < EPT / 2; ++h) {
    const int kb = t + h * SMALL_THREADS;
    uint32_t a[WORDS], b[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      a[k] = s[k][kb];
      b[k] = s[k][kb + TILE / 2];
    }
    twiddle<A>(b, tw, tw_ld, (TILE / 2 - 1) + kb, M);
    butterfly<A>(a, b, M);
    store_elem(out, n, base + kb, a);
    store_elem(out, n, base + kb + TILE / 2, b);
  }
}

// i with its LOGN low bits reversed (i < 2^LOGN)
template <int LOGN>
__device__ __forceinline__ int bit_reverse(int i) {
  if constexpr (LOGN == 0) {
    return 0;
  } else {
    return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - LOGN));
  }
}

// The whole transform of n = 2^LOGN < TILE points on each of ``cols``
// columns, natural order in and out (the bit-reversal in the load).
template <class A, int LOGN>
__global__ void __launch_bounds__(SMALL_THREADS)
ntt_small_stages_kernel_columns(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int cols,
                                const uint32_t* __restrict__ tw, Modulus M) {
  constexpr int N = 1 << LOGN;
  constexpr int TW_LD = N - 1;
  __shared__ __align__(16) uint32_t s[WORDS][TILE];
  const size_t run = static_cast<size_t>(blockIdx.x) * TILE;  // a multiple of N: whole columns
  const size_t total = static_cast<size_t>(cols) * N;
  const int t = threadIdx.x;

  // element e of the run is element i = e mod N of column (run + e) / N, at
  // word (run + e - i) * 16 + limb * N + i of the batch
#pragma unroll
  for (int h = 0; h < EPT; ++h) {
    const int e = t + h * SMALL_THREADS;
    if (run + e >= total) break;
    const int i = e & (N - 1);
    uint32_t w[WORDS];
    load_elem(x + (run + e - i) * LIMBS, N, i, w);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) s[k][e - i + bit_reverse<LOGN>(i)] = w[k];
  }
  __syncthreads();

#pragma unroll
  for (int lm = 0; lm < LOGN; ++lm) {
    const int m = 1 << lm;
#pragma unroll
    for (int h = 0; h < EPT / 2; ++h) {
      const int kb = t + h * SMALL_THREADS;
      const int j = kb & (m - 1);
      const int i0 = 2 * (kb - j) + j;
      if (run + i0 < total) {  // a column of the batch (i0 and i0 + m share it)
        uint32_t a[WORDS], b[WORDS];
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
          a[k] = s[k][i0];
          b[k] = s[k][i0 + m];
        }
        if (j > 0) twiddle<A>(b, tw, TW_LD, (m - 1) + j, M);  // w^0 = 1 leaves a canonical b as it is
        butterfly<A>(a, b, M);
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
          s[k][i0] = a[k];
          s[k][i0 + m] = b[k];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < EPT; ++h) {
    const int e = t + h * SMALL_THREADS;
    if (run + e >= total) break;
    const int i = e & (N - 1);
    uint32_t w[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = s[k][e];
    store_elem(out + (run + e - i) * LIMBS, N, i, w);
  }
}

// The shared-memory slot of tile element e: bit 4 flipped where bit 5 is
// set.  A stage's butterfly b = 16 q + t pairs the elements 16 h0 + t and
// 16 (h0 + 2^s) + t; a warp holds q and q + 1 (q even), whose first elements
// are 16 apart (s > 0, the same bit 5) or 32 apart (s = 0, bit 5 differs),
// so with the flip the two half-warps take different banks.
__device__ __forceinline__ int slot(int e) { return e ^ ((e >> 1) & FUSE_T); }

template <class A>
__global__ void __launch_bounds__(LARGE_THREADS)
ntt_large_stage_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n, int m0,
                        int stages, const uint32_t* __restrict__ tw, Modulus M) {
  extern __shared__ __align__(16) uint32_t s[];  // [WORDS][E]
  const size_t col = static_cast<size_t>(blockIdx.y) * LIMBS * n;
  x += col;
  out += col;
  const int E = FUSE_T << stages;
  const int groups = m0 / FUSE_T;  // blocks along the low offsets
  const int j0 = static_cast<int>(blockIdx.x % groups) * FUSE_T;
  const size_t base = static_cast<size_t>(blockIdx.x / groups) * (static_cast<size_t>(m0) << stages) + j0;

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    uint32_t w[WORDS];
    load_elem(x, n, base + (e & (FUSE_T - 1)) + static_cast<size_t>(e / FUSE_T) * m0, w);
    const int p = slot(e);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) s[k * E + p] = w[k];
  }
  __syncthreads();

  const int half = E / 2;
  for (int st = 0; st < stages; ++st) {
    const int m = m0 << st;
    const int low = (1 << st) - 1;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int t = b & (FUSE_T - 1);
      const int q = b / FUSE_T;
      const int h0 = ((q >> st) << (st + 1)) | (q & low);
      const int p0 = slot(h0 * FUSE_T + t);
      const int p1 = slot((h0 + (1 << st)) * FUSE_T + t);
      uint32_t a[WORDS], v[WORDS];
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        a[k] = s[k * E + p0];
        v[k] = s[k * E + p1];
      }
      twiddle<A>(v, tw, n - 1, (m - 1) + j0 + t + (q & low) * m0, M);
      butterfly<A>(a, v, M);
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        s[k * E + p0] = a[k];
        s[k * E + p1] = v[k];
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    uint32_t w[WORDS];
    const int p = slot(e);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = s[k * E + p];
    store_elem(out, n, base + (e & (FUSE_T - 1)) + static_cast<size_t>(e / FUSE_T) * m0, w);
  }
}

template <class A, int LOGN>
void launch_columns(const void* x, void* out, int cols, const void* tw, const Modulus& M,
                    cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(cols) * (1 << LOGN) + TILE - 1) / TILE;
  ntt_small_stages_kernel_columns<A, LOGN><<<static_cast<unsigned>(blocks), SMALL_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), cols,
      static_cast<const uint32_t*>(tw), M);
}

// n >= TILE: the tile kernel over a bit-reversed input; n < TILE: the whole
// transform of each column (natural order in and out), one instance of
// ntt_small_stages_kernel_columns per log2 n.
template <class A>
cudaError_t launch_small(const void* x, void* out, int n, int cols, const void* tw, const Modulus& M,
                         cudaStream_t stream) {
  if (n >= TILE) {
    ntt_small_stages_kernel<A><<<dim3(n / TILE, cols), SMALL_THREADS, 0, stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
        static_cast<const uint32_t*>(tw), M);
    return cudaSuccess;
  }
  switch (n) {
    case 1: launch_columns<A, 0>(x, out, cols, tw, M, stream); break;
    case 2: launch_columns<A, 1>(x, out, cols, tw, M, stream); break;
    case 4: launch_columns<A, 2>(x, out, cols, tw, M, stream); break;
    case 8: launch_columns<A, 3>(x, out, cols, tw, M, stream); break;
    case 16: launch_columns<A, 4>(x, out, cols, tw, M, stream); break;
    case 32: launch_columns<A, 5>(x, out, cols, tw, M, stream); break;
    case 64: launch_columns<A, 6>(x, out, cols, tw, M, stream); break;
    case 128: launch_columns<A, 7>(x, out, cols, tw, M, stream); break;
    case 256: launch_columns<A, 8>(x, out, cols, tw, M, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <class A>
void launch_large(const void* x, void* out, int n, int cols, int m0, int stages, const void* tw,
                  const Modulus& M, cudaStream_t stream) {
  const int elems = FUSE_T << stages;
  const int threads = elems / 2 < LARGE_THREADS ? elems / 2 : LARGE_THREADS;
  const size_t smem = static_cast<size_t>(elems) * WORDS * sizeof(uint32_t);
  ntt_large_stage_kernel<A><<<dim3(n / elems, cols), threads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, m0, stages,
      static_cast<const uint32_t*>(tw), M);
}

}  // namespace

// Every stage with half-size m = 1 .. min(n, TILE) / 2 on each of ``cols``
// columns: for n a multiple of 512 over a bit-reversed input (x and out
// 16-byte aligned), for n = 1 .. 256 (a power of two) over a natural-order
// one, which is then the whole transform.  arith: 0 = CcArith (p < 2^254),
// 1 = WideArith.
extern "C" int h2t_ntt_small_stages(const void* x, void* out, int n, int cols, const void* tw,
                                    const void* modulus, int arith, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (arith == 0) {
    rc = launch_small<CcArith>(x, out, n, cols, tw, M, s);
  } else if (arith == 1) {
    rc = launch_small<WideArith>(x, out, n, cols, tw, M, s);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The ``stages`` consecutive stages with half-sizes m0, 2 m0, .., m0 2^(stages
// - 1) (m0 a power of two >= 512, 1 <= stages <= MAX_STAGES, m0 2^stages <=
// n) on each of ``cols`` columns.  arith as above.
extern "C" int h2t_ntt_large_stage(const void* x, void* out, int n, int cols, int m0, int stages,
                                   const void* tw, const void* modulus, int arith, void* stream) {
  if (stages < 1 || stages > MAX_STAGES || m0 < TILE || (m0 & (m0 - 1)) ||
      static_cast<long long>(m0) << stages > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith == 0) {
    launch_large<CcArith>(x, out, n, cols, m0, stages, tw, M, s);
  } else if (arith == 1) {
    launch_large<WideArith>(x, out, n, cols, m0, stages, tw, M, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

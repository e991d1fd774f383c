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
// integer units; each large stage is one pass for one multiply, bound by
// memory.
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
// ntt_large_stage: one thread per butterfly, grid (n / 512, C).  Fusing
// several large stages per pass (a larger radix or a four-step transform)
// is the next step.

#include "arith.cuh"

using namespace h2t;

namespace {

constexpr int TILE = 512;  // elements per block, small-stages kernel
constexpr int EPT = 4;      // elements per thread, small-stages kernel
constexpr int SMALL_THREADS = TILE / EPT;
constexpr int LIMBS = 2 * WORDS;
constexpr int LARGE_THREADS = 256;

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

template <class A>
__global__ void __launch_bounds__(LARGE_THREADS)
ntt_large_stage_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n, int m,
                       const uint32_t* __restrict__ tw, Modulus M) {
  const size_t col = static_cast<size_t>(blockIdx.y) * LIMBS * n;
  x += col;
  out += col;
  const size_t kb = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kb >= static_cast<size_t>(n / 2)) return;
  const size_t j = kb & static_cast<size_t>(m - 1);
  const size_t i0 = 2 * (kb - j) + j;
  const size_t i1 = i0 + m;
  uint32_t a[WORDS], b[WORDS];
  load_elem(x, n, i0, a);
  load_elem(x, n, i1, b);
  twiddle<A>(b, tw, n - 1, (m - 1) + static_cast<int>(j), M);
  butterfly<A>(a, b, M);
  store_elem(out, n, i0, a);
  store_elem(out, n, i1, b);
}

template <class A>
void launch_small(const void* x, void* out, int n, int cols, const void* tw, const Modulus& M,
                  cudaStream_t stream) {
  ntt_small_stages_kernel<A><<<dim3(n / TILE, cols), SMALL_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
      static_cast<const uint32_t*>(tw), M);
}

template <class A>
void launch_large(const void* x, void* out, int n, int cols, int m, const void* tw, const Modulus& M,
                  cudaStream_t stream) {
  const int blocks = (n / 2 + LARGE_THREADS - 1) / LARGE_THREADS;
  ntt_large_stage_kernel<A><<<dim3(blocks, cols), LARGE_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, m,
      static_cast<const uint32_t*>(tw), M);
}

}  // namespace

// Every stage with half-size m = 1 .. 256 on each of ``cols`` columns; n a
// multiple of 512, x and out 16-byte aligned.  arith: 0 = CcArith (p < 2^254),
// 1 = WideArith.
extern "C" int h2t_ntt_small_stages(const void* x, void* out, int n, int cols, const void* tw,
                                    const void* modulus, int arith, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith == 0) {
    launch_small<CcArith>(x, out, n, cols, tw, M, s);
  } else if (arith == 1) {
    launch_small<WideArith>(x, out, n, cols, tw, M, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One stage with half-size m (a power of two, 512 <= m <= n / 2) on each of
// ``cols`` columns.  arith as above.
extern "C" int h2t_ntt_large_stage(const void* x, void* out, int n, int cols, int m, const void* tw,
                                   const void* modulus, int arith, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith == 0) {
    launch_large<CcArith>(x, out, n, cols, m, tw, M, s);
  } else if (arith == 1) {
    launch_large<WideArith>(x, out, n, cols, m, tw, M, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Radix-2 NTT butterfly stages over a bit-reversed (16, n) limb array.
//
// Replaces halo2_tpu/poly/pallas_ntt.py:_small_stages_kernel (every stage
// with half-size m <= 256, fused per 512-element tile) and
// _large_stage_kernel (one stage with m >= 512), composed by ntt_stages there
// and by halo2_tpu_torch/poly/cuda_ntt.py:ntt_stages here.  A stage with
// half-size m pairs element i0 = (k / m) * 2m + (k mod m) with i1 = i0 + m and
// writes a + b * w^(k mod m) to i0 and a - b * w^(k mod m) to i1.
//
// Twiddles: one (16, n - 1) limb table per (n, direction); the m twiddles of
// the stage with half-size m start at column m - 1.
//
// What bounds it on an H100: a butterfly is one Montgomery multiply (~136
// 32-bit multiply-adds) plus a mod-add and a mod-sub, against 256 bytes of
// element traffic (two elements in, two out) and a twiddle read.  Each large
// stage is a full pass over device memory, so the ladder is bound by memory
// traffic: ~log2(n) - 9 + 1 passes.  This simple design fuses the nine small
// stages into one pass through shared memory (a 512-element tile is 16 KB as
// 8-word elements, word-major so that consecutive elements fall on
// consecutive banks) and runs each large stage as one thread per butterfly.
// Unlike the TPU kernel it does not multiply the a-lanes by one, and it
// skips the multiply in the m = 1 stage, whose only twiddle is 1.  Fusing
// several large stages per pass (a larger radix or a four-step transform) is
// the next step.

#include "field.cuh"

using namespace h2t;

namespace {

constexpr int TILE = 512;                // elements per block, small-stages kernel
constexpr int BUTTERFLIES = TILE / 2;    // one butterfly per thread per stage

__device__ __forceinline__ void butterfly(uint32_t a[WORDS], uint32_t b[WORDS],
                                          const uint32_t* __restrict__ tw, int tw_ld,
                                          int m, int j, const Modulus& M) {
  if (m > 1) {
    uint32_t w[WORDS], t[WORDS];
    load_elem(tw, tw_ld, (m - 1) + j, w);
    mont_mul(b, w, M, t);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) b[k] = t[k];
  }
  uint32_t u[WORDS], v[WORDS];
  mod_add(a, b, M, u);
  mod_sub(a, b, M, v);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = u[k];
    b[k] = v[k];
  }
}

__global__ void __launch_bounds__(BUTTERFLIES)
ntt_small_stages_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n,
                        const uint32_t* __restrict__ tw, int tw_ld, Modulus M) {
  __shared__ uint32_t s[WORDS][TILE];
  const size_t base = static_cast<size_t>(blockIdx.x) * TILE;
  for (int e = threadIdx.x; e < TILE; e += BUTTERFLIES) {
    uint32_t w[WORDS];
    load_elem(x, n, base + e, w);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) s[k][e] = w[k];
  }
  __syncthreads();
  const int kb = threadIdx.x;
  for (int m = 1; m <= TILE / 2; m <<= 1) {
    const int j = kb & (m - 1);
    const int i0 = 2 * (kb - j) + j;
    const int i1 = i0 + m;
    uint32_t a[WORDS], b[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      a[k] = s[k][i0];
      b[k] = s[k][i1];
    }
    butterfly(a, b, tw, tw_ld, m, j, M);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      s[k][i0] = a[k];
      s[k][i1] = b[k];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < TILE; e += BUTTERFLIES) {
    uint32_t w[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = s[k][e];
    store_elem(out, n, base + e, w);
  }
}

__global__ void ntt_large_stage_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                       int n, int m, const uint32_t* __restrict__ tw, int tw_ld,
                                       Modulus M) {
  const size_t kb = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kb >= static_cast<size_t>(n / 2)) return;
  const size_t j = kb & static_cast<size_t>(m - 1);
  const size_t i0 = 2 * (kb - j) + j;
  const size_t i1 = i0 + m;
  uint32_t a[WORDS], b[WORDS];
  load_elem(x, n, i0, a);
  load_elem(x, n, i1, b);
  butterfly(a, b, tw, tw_ld, m, static_cast<int>(j), M);
  store_elem(out, n, i0, a);
  store_elem(out, n, i1, b);
}

}  // namespace

// Every stage with half-size m = 1 .. 256; n a multiple of 512.
extern "C" int h2t_ntt_small_stages(const void* x, void* out, int n, const void* tw, int tw_ld,
                                    const void* modulus, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  ntt_small_stages_kernel<<<n / TILE, BUTTERFLIES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n,
      static_cast<const uint32_t*>(tw), tw_ld, M);
  return static_cast<int>(cudaGetLastError());
}

// One stage with half-size m (a power of two, 512 <= m <= n / 2).
extern "C" int h2t_ntt_large_stage(const void* x, void* out, int n, int m, const void* tw,
                                   int tw_ld, const void* modulus, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const int threads = 256;
  const int blocks = (n / 2 + threads - 1) / threads;
  ntt_large_stage_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, m,
      static_cast<const uint32_t*>(tw), tw_ld, M);
  return static_cast<int>(cudaGetLastError());
}

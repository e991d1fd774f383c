// Batched Montgomery multiply: out = a * b * 2^-256 mod p, canonical; and
// batched Montgomery square: out = a * a * 2^-256 mod p, canonical.
//
// Replaces halo2_tpu/field/pallas_mul.py:_mont_mul_kernel (reached through
// _mont_mul_call and mont_mul), which the TPU computes with a byte-split bf16
// one-hot/Toeplitz matrix-unit reduction.  Here it is the textbook CIOS
// multiply on 8 x 32-bit words (field.cuh), one thread per element.
//
// What bounds it on an H100: each element moves 192 bytes (a, b and out, 16
// int32 limbs each, half of every limb word zero) and needs about 136 32-bit
// multiply-adds (64 for a * b, 64 for m * p, 8 for m).  At the H100 SXM's
// published 3.35 TB/s (data sheet, 700 W limit) the bytes allow ~17 G
// elements/s; the integer units allow several times that, so the kernel is
// bound by memory traffic.  This simple design reads each
// limb once, coalesced (limb-major layout, neighbouring threads on
// neighbouring elements), keeps every intermediate in registers, and writes
// the product once.  Packing limbs to 32 bits in memory would halve the
// traffic; that changes the layout the rest of the port shares, so it waits.
//
// b is either full width (b_bcast == 0) or one broadcast element (b_bcast ==
// 1, a (16, 1) column, e.g. the NTT's n^-1); m is arbitrary (bounds check,
// no padding).

#include "field.cuh"

using namespace h2t;

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int m, int b_bcast, Modulus M) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  uint32_t x[WORDS], y[WORDS], r[WORDS];
  load_elem(a, m, idx, x);
  if (b_bcast)
    load_elem(b, 1, 0, y);
  else
    load_elem(b, m, idx, y);
  mont_mul(x, y, M, r);
  store_elem(out, m, idx, r);
}

extern "C" int h2t_mont_mul(const void* a, const void* b, void* out, int m, int b_bcast,
                            const void* modulus, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const int threads = 256;
  const int blocks = (m + threads - 1) / threads;
  mont_mul_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), m, b_bcast, M);
  return static_cast<int>(cudaGetLastError());
}

// Replaces halo2_tpu/field/pallas_mul.py:_mont_sqr_kernel (reached through
// _mont_sqr_call and mont_sqr), which the TPU computes from the 136 limb
// products of the upper triangle.  Here: field.cuh's mont_sqr, 36
// word products for the square and 72 for the reduction, one thread per
// element.  It moves 128 bytes per element (a and out), so like mont_mul it
// is bound by memory traffic on an H100; its equality with mont_mul(a, a)
// is what the tests check.
__global__ void mont_sqr_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                                int m, Modulus M) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  uint32_t x[WORDS], r[WORDS];
  load_elem(a, m, idx, x);
  mont_sqr(x, M, r);
  store_elem(out, m, idx, r);
}

extern "C" int h2t_mont_sqr(const void* a, void* out, int m, const void* modulus, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const int threads = 256;
  const int blocks = (m + threads - 1) / threads;
  mont_sqr_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out), m, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* h2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

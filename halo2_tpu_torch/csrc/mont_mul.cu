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

#include "arith.cuh"

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

// Replaces halo2_tpu/field/device.py:239-253, DeviceField._pow_bits: a^e
// for an exponent the host knows (inv is a^(p - 2)), a jax.lax.scan over
// e's bits that XLA compiles into one device loop, where the port launched
// one mont_sqr and, on a 1 bit, one mont_mul a bit: 253 and 127 launches an
// inverse.  Here the whole ladder runs in one launch, one thread per
// element, its two values in registers: LSB first, the multiply skipped
// where a bit is 0 (the reference multiplies by one there, which gives the
// same limbs), the square skipped after the last bit; a^0 = one and 0^e = 0
// (inv(0) = 0).  The exponent is a device buffer of 32-bit words, least
// significant first, that every thread reads at the same address; the
// branches on its bits are uniform.  Templated on the arithmetic
// (arith.cuh): the carry chains for BN254's Fr and Fq, 64-bit accumulators
// for Pasta.
//
// What bounds it: integer multiplies, (bits - 1) squares of 216 IMADs and
// (popcount - 1) products of 272 an element, against its 128 bytes in and
// out: for p - 2 of BN254 Fr ~89,000 IMADs an element, ~0.011 ms for 2^11
// elements at 132 SMs x 64 x 1.98 GHz (chip_smoke.py computes it from the
// exponent).  Below 132 x 64 elements the integer lanes are not all busy,
// and the time tends to one thread's chain of ~380 dependent products.
constexpr int POW_THREADS = 128;

template <class A>
__global__ void __launch_bounds__(POW_THREADS)
mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int m,
                const uint32_t* __restrict__ exp_words, int nbits, ModulusOne C) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  uint32_t base[WORDS], acc[WORDS];
  load_elem(a, m, idx, base);
  bool started = false;
  uint32_t word = 0;
  for (int i = 0; i < nbits; ++i) {
    if ((i & 31) == 0) word = exp_words[i >> 5];
    if ((word >> (i & 31)) & 1u) {
      if (started) {
        A::mul(acc, base, C.M, acc);
      } else {
#pragma unroll
        for (int k = 0; k < WORDS; ++k) acc[k] = base[k];
        started = true;
      }
    }
    if (i + 1 < nbits) A::sqr(base, C.M, base);
  }
  if (!started) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) acc[k] = C.one[k];
  }
  store_elem(out, m, idx, acc);
}

// arith 0: carry chains (p < 2^254), 1: 64-bit accumulators.
extern "C" int h2t_mont_pow(const void* a, void* out, int m, const void* exp_words, int nbits,
                            const void* consts, int arith, void* stream) {
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + POW_THREADS - 1) / POW_THREADS;
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* e = static_cast<const uint32_t*>(exp_words);
  auto* o = static_cast<uint32_t*>(out);
  if (arith == 0) {
    mont_pow_kernel<CcArith><<<blocks, POW_THREADS, 0, s>>>(x, o, m, e, nbits, C);
  } else if (arith == 1) {
    mont_pow_kernel<WideArith><<<blocks, POW_THREADS, 0, s>>>(x, o, m, e, nbits, C);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* h2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

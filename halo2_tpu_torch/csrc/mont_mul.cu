// Batched Montgomery multiply over a batch of columns: out = a * b * 2^-256
// mod p, canonical; and batched Montgomery square: out = a * a * 2^-256 mod
// p, canonical.
//
// mont_mul replaces halo2_tpu/field/pallas_mul.py:_mont_mul_kernel (reached
// through _mont_mul_call and mont_mul, which takes any batch shape in one
// call: _tile_batched), which the TPU computes with a byte-split bf16
// one-hot/Toeplitz matrix-unit reduction.  Here it is the textbook CIOS
// multiply on 8 x 32-bit words (arith.cuh: the carry chains for BN254, 64-bit
// accumulators for Pasta).
//
// Shapes: a is C columns of (16, n) limbs, each column contiguous, a_cs
// int32 words from one column to the next (the flat (16, m) form is C = 1);
// out is a contiguous (C, 16, n).  b is full width, C columns at b_cs words
// apart (period = n), or one (16, period) array that every column shares
// (b_cs = 0), period dividing n: element j of a column meets b[:, j mod
// period].  That covers a (16, n) b shared by every column (the coset
// powers, a sharded NTT's twiddles), one element (period 1: n^-1) and a
// stage ladder's (16, m) twiddles (period m).
//
// What bounds it on an H100: memory traffic, once the batch fills the card.
// Each element reads a and writes out (128 bytes: 16 int32 limbs each, half
// of every limb word zero) and, with a b of its own, reads 64 more; a
// product is ~136 32-bit multiply-adds (64 for a * b, 64 for m * p, 8 for
// m), which the integer units finish in well under the bytes' time
// (chip_smoke.py prints both bounds).  The design: on a large batch
// (MUL_VEC_MIN_ELEMS elements and up) a thread owns 4 consecutive elements
// of a column, so each limb row is one 16-byte load (and store) and the 4
// products are independent work for the scheduler; below that a thread
// owns one element, since there one warp's product issue is the time (a
// product is ~0.42 us in one thread, chip_smoke.py's chained-product
// microbenchmark) and more warps finish sooner (measured on one H100: a
// lone 2^11 or 2^15 column took 0.0041-0.0045 ms at 4 elements a thread
// against 0.0026-0.0030 at one, PERF.md).  Four elements a thread need n %
// 4 == 0 and 16-byte aligned columns (every large batch a prove makes);
// anything else takes one element a thread.  A shared b is loaded into
// registers once, and the thread then loops over a group of columns
// (gridDim.y splits the C columns into groups, enough blocks left to fill
// 132 SMs), so a batch of C columns moves 128 + 64 / group bytes an
// element where C launches of one column each moved 192, and pays one
// launch.
#include "arith.cuh"

using namespace h2t;

constexpr int MUL_THREADS = 128;
constexpr int MUL_MAX_GROUP = 8;         // columns a thread serves with one load of a shared b
constexpr int MUL_MIN_BLOCKS = 4 * 132;  // keep at least this many blocks when grouping
constexpr long long MUL_VEC_MIN_ELEMS = 1 << 17;  // C x n from which a thread owns 4 elements

// The E elements e0 .. e0 + E - 1 of a (16, ld) limb array into words w:
// E = 4 (vectorized: all four exist and base + e0 is 16-byte aligned) one
// uint4 a limb row, E = 1 one limb at a time.
template <int E>
__device__ __forceinline__ void load_elems(const uint32_t* __restrict__ base, size_t ld, size_t e0,
                                           uint32_t w[E][WORDS]) {
  if constexpr (E == 4) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const uint4 lo = *reinterpret_cast<const uint4*>(base + (2 * k) * ld + e0);
      const uint4 hi = *reinterpret_cast<const uint4*>(base + (2 * k + 1) * ld + e0);
      w[0][k] = lo.x | (hi.x << 16);
      w[1][k] = lo.y | (hi.y << 16);
      w[2][k] = lo.z | (hi.z << 16);
      w[3][k] = lo.w | (hi.w << 16);
    }
  } else {
    load_elem(base, ld, e0, w[0]);
  }
}

template <int E>
__device__ __forceinline__ void store_elems(uint32_t* __restrict__ base, size_t ld, size_t e0,
                                            const uint32_t w[E][WORDS]) {
  if constexpr (E == 4) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      *reinterpret_cast<uint4*>(base + (2 * k) * ld + e0) =
          make_uint4(w[0][k] & 0xFFFFu, w[1][k] & 0xFFFFu, w[2][k] & 0xFFFFu, w[3][k] & 0xFFFFu);
      *reinterpret_cast<uint4*>(base + (2 * k + 1) * ld + e0) =
          make_uint4(w[0][k] >> 16, w[1][k] >> 16, w[2][k] >> 16, w[3][k] >> 16);
    }
  } else {
    store_elem(base, ld, e0, w[0]);
  }
}

// b's elements for a's e0 .. e0 + E - 1: b[:, (e0 + i) mod period], one
// uint4 a limb row where bvec (E = 4, period % 4 == 0, b aligned), else
// one element at a time (periods 1 and 2).
template <int E>
__device__ __forceinline__ void load_b(const uint32_t* __restrict__ b, size_t period, size_t e0, bool bvec,
                                       uint32_t w[E][WORDS]) {
  if (E == 4 && bvec) {
    load_elems<E>(b, period, e0 % period, w);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) load_elem(b, period, (e0 + i) % period, w[i]);
  }
}

template <class A, int E>
__global__ void __launch_bounds__(MUL_THREADS)
mont_mul_kernel(const uint32_t* __restrict__ a, long long a_cs, const uint32_t* __restrict__ b,
                long long b_cs, int period, bool bvec, uint32_t* __restrict__ out, int n, int cols,
                int group, Modulus M) {
  const size_t e0 = (static_cast<size_t>(blockIdx.x) * MUL_THREADS + threadIdx.x) * E;
  const size_t nn = static_cast<size_t>(n), P = static_cast<size_t>(period);
  if (e0 >= nn) return;
  uint32_t x[E][WORDS], y[E][WORDS], r[E][WORDS];
  if (b_cs == 0) load_b<E>(b, P, e0, bvec, y);  // shared: once for every column
  for (int c0 = blockIdx.y * group; c0 < cols; c0 += gridDim.y * group) {
    const int c1 = min(cols, c0 + group);
    for (int c = c0; c < c1; ++c) {
      if (b_cs != 0) load_b<E>(b + c * b_cs, P, e0, bvec, y);
      load_elems<E>(a + c * a_cs, nn, e0, x);
#pragma unroll
      for (int i = 0; i < E; ++i) A::mul(x[i], y[i], M, r[i]);
      store_elems<E>(out + static_cast<size_t>(c) * 16 * nn, nn, e0, r);
    }
  }
}

template <class A>
static void launch_mont_mul(const uint32_t* a, long long a_cs, const uint32_t* b, long long b_cs, int period,
                            uint32_t* out, int n, int cols, bool vec, bool bvec, const Modulus& M,
                            cudaStream_t s) {
  const int e = vec && static_cast<long long>(cols) * n >= MUL_VEC_MIN_ELEMS ? 4 : 1;
  const long long bx = ((n + e - 1) / e + MUL_THREADS - 1) / MUL_THREADS;
  int group = 1;
  while (b_cs == 0 && group < MUL_MAX_GROUP && bx * ((cols + 2 * group - 1) / (2 * group)) >= MUL_MIN_BLOCKS)
    group *= 2;
  const int groups = (cols + group - 1) / group;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(groups < 65535 ? groups : 65535));
  if (e == 4) {
    mont_mul_kernel<A, 4><<<grid, MUL_THREADS, 0, s>>>(a, a_cs, b, b_cs, period, bvec, out, n, cols, group, M);
  } else {
    mont_mul_kernel<A, 1><<<grid, MUL_THREADS, 0, s>>>(a, a_cs, b, b_cs, period, false, out, n, cols, group, M);
  }
}

// vec: n % 4 == 0 and a, out and their column strides 16-byte aligned (the
// wrapper checks); bvec: vec, period % 4 == 0 and b (and b_cs) aligned.
// arith 0: carry chains (p < 2^254), 1: 64-bit accumulators.
extern "C" int h2t_mont_mul(const void* a, long long a_cs, const void* b, long long b_cs, int period,
                            void* out, int n, int cols, int vec, int bvec, int arith,
                            const void* modulus, void* stream) {
  if (n <= 0 || cols <= 0 || period <= 0 || n % period) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith == 0) {
    launch_mont_mul<CcArith>(x, a_cs, y, b_cs, period, o, n, cols, vec, bvec, M, s);
  } else if (arith == 1) {
    launch_mont_mul<WideArith>(x, a_cs, y, b_cs, period, o, n, cols, vec, bvec, M, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The chained-product latency of the curve kernels', jac_horner's and
// mont_pow's Montgomery product, cc::mul (chip_smoke.py phase 2): one
// thread computes x <- x * b, iters times, so the launch's device time over
// iters is one product's chain.  A measurement, on no prove path.
__global__ void mul_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int iters, Modulus M) {
  uint32_t x[WORDS], y[WORDS];
  load_elem(a, 1, 0, x);
  load_elem(b, 1, 0, y);
  for (int i = 0; i < iters; ++i) cc::mul(x, y, M, x);
  store_elem(out, 1, 0, x);
}

extern "C" int h2t_mul_chain(const void* a, const void* b, void* out, int iters, const void* modulus,
                             void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  mul_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), iters, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* h2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Batched field inverse: out = a^-1 for a Montgomery array (a R -> a^-1 R),
// canonical, inv(0) = 0.
//
// Replaces halo2_tpu/field/device.py:251, DeviceField.inv: a^(p - 2) as a
// lax.scan over the exponent's bits (253 squares and 127 products) that XLA
// compiles into one device loop.  The port first ran that ladder as the
// mont_pow kernel (mont_mul.cu), one thread chaining 379 dependent
// Montgomery products of ~320 instructions each.  Here the inverse is the
// Bernstein-Yang safegcd in the form of libsecp256k1's modinv32
// (constant-time variant):
//
// - a value is 9 signed 30-bit limbs (270 bits: any 256-bit value, and the
//   signed intermediates);
// - f = p, g = x, d = 0, e = 1, zeta = -1 (zeta = -(delta + 1/2));
// - each batch runs 30 divsteps on the low limbs of f and g alone, which
//   yields a 2x2 transition matrix t scaled by 2^30 (divsteps_30), and then
//   applies t / 2^30 to (f, g) exactly (update_fg) and to (d, e) mod p, adding
//   the multiple of p that clears the low 30 bits (update_de);
// - after the batches g = 0 and f = +-gcd(p, x) = +-1, and d = +-x^-1 mod p
//   (normalize: into [0, p), negated where f = -1).
//
// The count is fixed: BATCHES x 30 = 600 divsteps, as modinv32 runs; its
// source states that 590 suffice for every input below 2^256 (the
// Bernstein-Yang bound for this half-delta divstep), which covers BN254's
// 254-bit and Pasta's 255-bit moduli.  So every lane of a warp runs the same
// instructions and the time does not depend on the value.  For x = a R the
// GCD gives x^-1 = a^-1 R^-1; one Montgomery product by R^3 mod p (a host
// constant) makes it a^-1 R.  x = 0 leaves d = 0, so inv(0) = 0.
//
// What bounds it on an H100: one thread's chain.  A divstep is ~25
// dependent 32-bit operations on the low words; each batch's matrix
// products (update_de and update_fg: 91 32x32->64 products and their
// carries) add a few hundred more.  Against its 128 bytes an element of
// traffic the integer work is the larger bound at every size (chip_smoke.py
// computes both), and below 132 x 64 elements the integer lanes are not all
// busy, so the time tends to one lane's 600 divsteps.  One thread an
// element; each thread's state (f, g, d, e) lives in registers (60 of them).
// The closing product is arith.cuh's: the carry chains for BN254's Fr and
// Fq, 64-bit accumulators for Pasta.  One NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md) ran 2^11 elements in 0.024 ms (~80 cycles a divstep; mont_pow's
// a^(p - 2) took 0.173) and 2^16 in 0.068 ms, 48 % of the least issue
// slots' time.

#include "arith.cuh"

using namespace h2t;

namespace {

constexpr int INV_THREADS = 128;
constexpr int LIMBS30 = 9;     // signed 30-bit limbs a value
constexpr int BATCHES = 20;    // of 30 divsteps: 600 >= 590
constexpr uint32_t M30 = 0x3FFFFFFFu;

// The kernel's constants, from a 27-word host array: p and n0 (words 0-8,
// the closing product's), R^3 mod p (9-16), p in 30-bit limbs (17-25) and
// p^-1 mod 2^30 (26).
struct InvConsts {
  Modulus M;
  uint32_t r3[WORDS];
  int32_t p30[LIMBS30];
  uint32_t p_inv30;
};

InvConsts inv_consts_from_host(const uint32_t* w) {
  InvConsts c;
  c.M = modulus_from_host(w);
  for (int k = 0; k < WORDS; ++k) c.r3[k] = w[WORDS + 1 + k];
  for (int k = 0; k < LIMBS30; ++k) c.p30[k] = static_cast<int32_t>(w[2 * WORDS + 1 + k]);
  c.p_inv30 = w[2 * WORDS + 1 + LIMBS30];
  return c;
}

// The transition matrix of 30 divsteps, scaled by 2^30: entries in
// [-2^30, 2^30].
struct Trans {
  int32_t u, v, q, r;
};

// 30 divsteps from zeta on f0 (odd) and g0, the low limbs of f and g (the
// low 30 bits decide 30 steps); returns the new zeta.  u, v, q, r run as
// uint32 (mod 2^32, which shifts left without overflow) and fit an int32.
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f0, uint32_t g0, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    const uint32_t c1 = static_cast<uint32_t>(zeta >> 31);  // all ones where zeta < 0
    const uint32_t c2 = 0u - (g & 1u);                      // all ones where g is odd
    // g += (zeta < 0 ? -f : f) where g is odd, and q, r with it
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    // zeta < 0 and g odd: f takes the old g (f + (g - f)), zeta -> -zeta - 2; else zeta - 1
    const uint32_t c3 = c1 & c2;
    zeta = (zeta ^ static_cast<int32_t>(c3)) - 1;
    f += g & c3;
    u += q & c3;
    v += r & c3;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = {static_cast<int32_t>(u), static_cast<int32_t>(v), static_cast<int32_t>(q), static_cast<int32_t>(r)};
  return zeta;
}

// (d, e) <- t (d, e) / 2^30 mod p: md, me (multiples of p) make the low 30
// bits of both sums zero; d, e stay in (-2p, p), their limbs below 2^30.
__device__ __forceinline__ void update_de(int32_t d[LIMBS30], int32_t e[LIMBS30], const Trans& t,
                                          const InvConsts& C) {
  const int32_t sd = d[LIMBS30 - 1] >> 31, se = e[LIMBS30 - 1] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = static_cast<int64_t>(t.u) * d[0] + static_cast<int64_t>(t.v) * e[0];
  int64_t ce = static_cast<int64_t>(t.q) * d[0] + static_cast<int64_t>(t.r) * e[0];
  md -= static_cast<int32_t>((C.p_inv30 * static_cast<uint32_t>(cd) + static_cast<uint32_t>(md)) & M30);
  me -= static_cast<int32_t>((C.p_inv30 * static_cast<uint32_t>(ce) + static_cast<uint32_t>(me)) & M30);
  cd += static_cast<int64_t>(C.p30[0]) * md;
  ce += static_cast<int64_t>(C.p30[0]) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < LIMBS30; ++i) {
    cd += static_cast<int64_t>(t.u) * d[i] + static_cast<int64_t>(t.v) * e[i];
    ce += static_cast<int64_t>(t.q) * d[i] + static_cast<int64_t>(t.r) * e[i];
    cd += static_cast<int64_t>(C.p30[i]) * md;
    ce += static_cast<int64_t>(C.p30[i]) * me;
    d[i - 1] = static_cast<int32_t>(static_cast<uint32_t>(cd) & M30);
    e[i - 1] = static_cast<int32_t>(static_cast<uint32_t>(ce) & M30);
    cd >>= 30;
    ce >>= 30;
  }
  d[LIMBS30 - 1] = static_cast<int32_t>(cd);
  e[LIMBS30 - 1] = static_cast<int32_t>(ce);
}

// (f, g) <- t (f, g) / 2^30, exact (the low 30 bits of both sums are zero).
__device__ __forceinline__ void update_fg(int32_t f[LIMBS30], int32_t g[LIMBS30], const Trans& t) {
  int64_t cf = static_cast<int64_t>(t.u) * f[0] + static_cast<int64_t>(t.v) * g[0];
  int64_t cg = static_cast<int64_t>(t.q) * f[0] + static_cast<int64_t>(t.r) * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < LIMBS30; ++i) {
    cf += static_cast<int64_t>(t.u) * f[i] + static_cast<int64_t>(t.v) * g[i];
    cg += static_cast<int64_t>(t.q) * f[i] + static_cast<int64_t>(t.r) * g[i];
    f[i - 1] = static_cast<int32_t>(static_cast<uint32_t>(cf) & M30);
    g[i - 1] = static_cast<int32_t>(static_cast<uint32_t>(cg) & M30);
    cf >>= 30;
    cg >>= 30;
  }
  f[LIMBS30 - 1] = static_cast<int32_t>(cf);
  g[LIMBS30 - 1] = static_cast<int32_t>(cg);
}

// Limbs below 2^30 again, the carries into the top limb.
__device__ __forceinline__ void propagate(int32_t d[LIMBS30]) {
#pragma unroll
  for (int i = 0; i < LIMBS30 - 1; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] = static_cast<int32_t>(static_cast<uint32_t>(d[i]) & M30);
  }
}

// d in (-2p, p) -> d mod p in [0, p), negated first where sign < 0 (f = -1).
__device__ __forceinline__ void normalize(int32_t d[LIMBS30], int32_t sign, const InvConsts& C) {
  int32_t add = d[LIMBS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) d[i] += C.p30[i] & add;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) d[i] = (d[i] ^ neg) - neg;
  propagate(d);
  add = d[LIMBS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) d[i] += C.p30[i] & add;
  propagate(d);
}

template <class A>
__global__ void __launch_bounds__(INV_THREADS)
mont_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int m, InvConsts C) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  uint32_t w[WORDS + 1];
  load_elem(a, m, idx, w);
  w[WORDS] = 0;
  int32_t f[LIMBS30], g[LIMBS30], d[LIMBS30], e[LIMBS30];
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) {  // limb i: bits 30 i .. 30 i + 29
    const int lo = 30 * i / 32, sh = 30 * i % 32;
    const uint64_t pair = w[lo] | static_cast<uint64_t>(w[lo + 1]) << 32;
    g[i] = static_cast<int32_t>(static_cast<uint32_t>(pair >> sh) & M30);
    f[i] = C.p30[i];
    d[i] = 0;
    e[i] = i == 0;
  }
  int32_t zeta = -1;
  for (int b = 0; b < BATCHES; ++b) {
    Trans t;
    zeta = divsteps_30(zeta, static_cast<uint32_t>(f[0]), static_cast<uint32_t>(g[0]), t);
    update_de(d, e, t, C);
    update_fg(f, g, t);
  }
  normalize(d, f[LIMBS30 - 1], C);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {  // word k: bits 32 k .. 32 k + 31, from limbs lo and lo + 1
    const int lo = 32 * k / 30, sh = 32 * k % 30;
    const uint64_t pair =
        static_cast<uint32_t>(d[lo]) | static_cast<uint64_t>(static_cast<uint32_t>(d[lo + 1])) << 30;
    w[k] = static_cast<uint32_t>(pair >> sh);
  }
  uint32_t res[WORDS];
  A::mul(w, C.r3, C.M, res);
  store_elem(out, m, idx, res);
}

}  // namespace

// out = a^-1 (Montgomery in and out) for the m elements of a (16, m) array;
// consts: the 27 words of InvConsts; arith 0: carry chains (p < 2^254), 1:
// 64-bit accumulators.
extern "C" int h2t_mont_inv(const void* a, void* out, int m, const void* consts, int arith, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const InvConsts C = inv_consts_from_host(static_cast<const uint32_t*>(consts));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + INV_THREADS - 1) / INV_THREADS;
  const auto* x = static_cast<const uint32_t*>(a);
  auto* o = static_cast<uint32_t*>(out);
  if (arith == 0) {
    mont_inv_kernel<CcArith><<<blocks, INV_THREADS, 0, s>>>(x, o, m, C);
  } else if (arith == 1) {
    mont_inv_kernel<WideArith><<<blocks, INV_THREADS, 0, s>>>(x, o, m, C);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

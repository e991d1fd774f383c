// Device functions for 256-bit prime-field arithmetic, shared by the kernels
// in mont_mul.cu and ntt.cu.
//
// In device memory an element is the reference layout: 16 little-endian
// 16-bit limbs, limb-major, `(16, ld)` int32 with limb j of element e at
// base[j * ld + e].  Neighbouring threads take neighbouring elements, so every
// limb load of a warp is one coalesced 128-byte transaction.  In registers an
// element is 8 little-endian 32-bit words.  Values are canonical (< p) in
// Montgomery form with R = 2^256 at every function boundary.
//
// The 64-bit accumulations below compile to the multiply-add-with-carry
// chains (mad.wide.u32, add.cc / addc) that multi-precision arithmetic wants.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace h2t {

constexpr int WORDS = 8;  // 32-bit words per element in registers

// The modulus and the CIOS constant n0 = -p^{-1} mod 2^32, passed to each
// kernel by value, so one kernel serves every field.
struct Modulus {
  uint32_t p[WORDS];
  uint32_t n0;
};

// Host side: the 9-word array the Python wrapper passes (p words, then n0).
inline Modulus modulus_from_host(const uint32_t* words) {
  Modulus m;
  for (int k = 0; k < WORDS; ++k) m.p[k] = words[k];
  m.n0 = words[WORDS];
  return m;
}

// The modulus and its Montgomery one (R mod p), passed by value to the
// kernels that start from one (the curve kernels' infinity, a power's
// empty product).
struct ModulusOne {
  Modulus M;
  uint32_t one[WORDS];
};

// Host side: the 17-word array the Python wrapper passes (p words, n0, one).
inline ModulusOne modulus_one_from_host(const uint32_t* words) {
  ModulusOne c;
  c.M = modulus_from_host(words);
  for (int k = 0; k < WORDS; ++k) c.one[k] = words[WORDS + 1 + k];
  return c;
}

__device__ __forceinline__ void load_elem(const uint32_t* __restrict__ base, size_t ld,
                                          size_t idx, uint32_t w[WORDS]) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k)
    w[k] = base[(2 * k) * ld + idx] | (base[(2 * k + 1) * ld + idx] << 16);
}

__device__ __forceinline__ void store_elem(uint32_t* __restrict__ base, size_t ld, size_t idx,
                                           const uint32_t w[WORDS]) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    base[(2 * k) * ld + idx] = w[k] & 0xFFFFu;
    base[(2 * k + 1) * ld + idx] = w[k] >> 16;
  }
}

// r = a + b over 8 words; returns the carry out.
__device__ __forceinline__ uint32_t add_words(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                              uint32_t r[WORDS]) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    c += static_cast<uint64_t>(a[k]) + b[k];
    r[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
}

// r = a - b over 8 words; returns the borrow out (1 when a < b).
__device__ __forceinline__ uint32_t sub_words(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                              uint32_t r[WORDS]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const uint64_t d = static_cast<uint64_t>(a[k]) - b[k] - borrow;
    r[k] = static_cast<uint32_t>(d);
    borrow = static_cast<uint32_t>(d >> 63);
  }
  return borrow;
}

// r = (a + b) mod p for a, b < p.
__device__ __forceinline__ void mod_add(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                        const Modulus& M, uint32_t r[WORDS]) {
  uint32_t s[WORDS], d[WORDS];
  const uint32_t carry = add_words(a, b, s);
  const uint32_t borrow = sub_words(s, M.p, d);
  const bool reduce = carry || !borrow;  // s >= p
#pragma unroll
  for (int k = 0; k < WORDS; ++k) r[k] = reduce ? d[k] : s[k];
}

// r = (a - b) mod p for a, b < p.
__device__ __forceinline__ void mod_sub(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                        const Modulus& M, uint32_t r[WORDS]) {
  uint32_t d[WORDS], e[WORDS];
  const uint32_t borrow = sub_words(a, b, d);
  add_words(d, M.p, e);  // wraps mod 2^256 back into [0, p) when a < b
#pragma unroll
  for (int k = 0; k < WORDS; ++k) r[k] = borrow ? e[k] : d[k];
}

// Montgomery product r = a * b * 2^-256 mod p for a, b < p (CIOS: each outer
// step adds a * b[i], then one multiple of p that clears the low word, and
// shifts by one word).  t stays below 2p, so one conditional subtract leaves
// r canonical: the same value as any other correct Montgomery multiply.
__device__ __forceinline__ void mont_mul(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                         const Modulus& M, uint32_t r[WORDS]) {
  uint32_t t[WORDS + 2];
#pragma unroll
  for (int k = 0; k < WORDS + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      c += static_cast<uint64_t>(a[j]) * b[i] + t[j];  // <= 2^64 - 1
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[WORDS];
    t[WORDS] = static_cast<uint32_t>(c);
    t[WORDS + 1] = static_cast<uint32_t>(c >> 32);

    const uint32_t m = t[0] * M.n0;
    c = (static_cast<uint64_t>(m) * M.p[0] + t[0]) >> 32;  // low word becomes 0
#pragma unroll
    for (int j = 1; j < WORDS; ++j) {
      c += static_cast<uint64_t>(m) * M.p[j] + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[WORDS];
    t[WORDS - 1] = static_cast<uint32_t>(c);
    t[WORDS] = t[WORDS + 1] + static_cast<uint32_t>(c >> 32);
  }
  uint32_t d[WORDS];
  const uint32_t borrow = sub_words(t, M.p, d);
  const bool reduce = t[WORDS] || !borrow;  // t >= p
#pragma unroll
  for (int k = 0; k < WORDS; ++k) r[k] = reduce ? d[k] : t[k];
}

// Montgomery square r = a * a * 2^-256 mod p for a < p, canonical: the same
// value as mont_mul(a, a).  The 512-bit square takes the 28 products a[i] a[j]
// (i < j) once, doubles them with one shift, and adds the 8 diagonal squares
// (36 multiplies instead of 64); then 8 separated REDC steps (SOS), each
// adding one multiple of p that clears the lowest word, whose carry out rides
// into the next step's top word.  (T + m p) / 2^256 < 2p, so one conditional
// subtract leaves r canonical.
__device__ __forceinline__ void mont_sqr(const uint32_t a[WORDS], const Modulus& M,
                                         uint32_t r[WORDS]) {
  uint32_t t[2 * WORDS + 1];
#pragma unroll
  for (int k = 0; k < 2 * WORDS + 1; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < WORDS - 1; ++i) {  // off-diagonal products, row by row
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < WORDS; ++j) {
      c += static_cast<uint64_t>(a[i]) * a[j] + t[i + j];
      t[i + j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    t[i + WORDS] = static_cast<uint32_t>(c);
  }
  uint32_t hi = 0;  // double: the off-diagonal sum is below 2^511
#pragma unroll
  for (int k = 0; k < 2 * WORDS; ++k) {
    const uint32_t next = t[k] >> 31;
    t[k] = (t[k] << 1) | hi;
    hi = next;
  }
  uint64_t c = 0;  // add the diagonal a[i]^2 at word 2i
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    const uint64_t sq = static_cast<uint64_t>(a[i]) * a[i];
    c += static_cast<uint64_t>(t[2 * i]) + static_cast<uint32_t>(sq);
    t[2 * i] = static_cast<uint32_t>(c);
    c >>= 32;
    c += static_cast<uint64_t>(t[2 * i + 1]) + (sq >> 32);
    t[2 * i + 1] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  uint32_t extra = 0;  // carry owed to word i + WORDS + 1
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    const uint32_t m = t[i] * M.n0;
    c = 0;
#pragma unroll
    for (int j = 0; j < WORDS; ++j) {
      c += static_cast<uint64_t>(m) * M.p[j] + t[i + j];
      t[i + j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += static_cast<uint64_t>(t[i + WORDS]) + extra;
    t[i + WORDS] = static_cast<uint32_t>(c);
    extra = static_cast<uint32_t>(c >> 32);
  }
  uint32_t d[WORDS];
  const uint32_t borrow = sub_words(t + WORDS, M.p, d);
  const bool reduce = extra || !borrow;  // t >= p
#pragma unroll
  for (int k = 0; k < WORDS; ++k) r[k] = reduce ? d[k] : t[WORDS + k];
}

__device__ __forceinline__ bool is_zero(const uint32_t a[WORDS]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) acc |= a[k];
  return acc == 0;
}

}  // namespace h2t

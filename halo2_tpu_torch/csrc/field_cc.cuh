// 256-bit prime-field arithmetic as PTX carry chains, for the curve kernels
// (jac.cu).  The same functions as field.cuh's mod_add, mod_sub, mont_mul and
// mont_sqr, giving the same canonical values, on the hardware carry flag
// (`mad.lo.cc` / `madc.hi.cc`) where field.cuh carries through 64-bit
// accumulators (`c += (u64)a*b + t`).
//
// What makes `mul` fast on sm_90a (measured, PERF.md): a chain that takes the
// low and then the high half of the SAME product (madc.lo then madc.hi of a[j]
// b) compiles to one IMAD.WIDE.U32.X, carry in and out; a chain of all the low
// halves followed by one of all the high halves compiles to an IMAD or
// IMAD.HI plus an IADD3.X each, twice the instructions on one serial carry
// chain.  `mul` is built from the first kind, in two independent chains per
// row.  An SOS square is of the second kind and measured slower than
// `mul(a, a)`, so `sqr` is that product.
//
// Each chain is one asm statement, so nothing the compiler schedules can
// clobber the carry flag inside it.  Elements are 8 little-endian 32-bit
// words in registers, canonical (< p) Montgomery form with R = 2^256.  The
// bounds below assume p < 2^254 (BN254's Fq is a 254-bit prime): then every
// CIOS intermediate fits in 9 words and a product's result, before its one
// conditional subtract, in 8.
#pragma once

#include "field.cuh"

namespace h2t {
namespace cc {

// r = a + b over 8 words; returns the carry out.
__device__ __forceinline__ uint32_t add8(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                         uint32_t r[WORDS]) {
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return c;
}

// r = a - b over 8 words; returns 0xFFFFFFFF when a < b (a borrow out), else 0.
__device__ __forceinline__ uint32_t sub8(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                         uint32_t r[WORDS]) {
  uint32_t m;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7]), "=r"(m)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return m;
}

// r = t >= p ? t - p : t, for t < 2^257 given as 8 words and a top bit.
__device__ __forceinline__ void reduce_once(const uint32_t t[WORDS], uint32_t top, const Modulus& M,
                                            uint32_t r[WORDS]) {
  uint32_t d[WORDS];
  const uint32_t borrow = sub8(t, M.p, d);
  const bool keep = !top && borrow;  // t < p
#pragma unroll
  for (int k = 0; k < WORDS; ++k) r[k] = keep ? t[k] : d[k];
}

// r = (a + b) mod p for a, b < p.
__device__ __forceinline__ void add(const uint32_t a[WORDS], const uint32_t b[WORDS], const Modulus& M,
                                    uint32_t r[WORDS]) {
  uint32_t s[WORDS];
  const uint32_t carry = add8(a, b, s);
  reduce_once(s, carry, M, r);
}

// r = 2a mod p.
__device__ __forceinline__ void dbl(const uint32_t a[WORDS], const Modulus& M, uint32_t r[WORDS]) {
  add(a, a, M, r);
}

// r = (a - b) mod p for a, b < p: the difference, plus p where it borrowed.
__device__ __forceinline__ void sub(const uint32_t a[WORDS], const uint32_t b[WORDS], const Modulus& M,
                                    uint32_t r[WORDS]) {
  uint32_t d[WORDS], q[WORDS];
  const uint32_t mask = sub8(a, b, d);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) q[k] = M.p[k] & mask;
  add8(d, q, r);  // wraps mod 2^256 back into [0, p) when a < b
}

// Montgomery product r = a * b * 2^-256 mod p for a, b < p: CIOS, with each
// row's carry chain split in two.  The running sum is t = X + 2^32 Y: the
// products a[j] b[i] of even j go into X (low half at word j, high at j + 1),
// those of odd j into Y, one word up; likewise m p[j] with m = X[0] n0.  So
// each row runs two independent chains of 8 multiply-adds where a single
// chain would run 16, and the carries of X and Y never meet until the end.
// The shift by one word after each row moves Y[0] + X[1] into X's word 0 and
// X[2..8] into Y; its carry rides into the next row's Y chain.  t stays below
// 2p < 2^255 between rows (the CIOS bound), so X needs 9 words and Y 8.
// Checked against an instruction-level model of the same carry flags.
__device__ __forceinline__ void mul(const uint32_t a[WORDS], const uint32_t b[WORDS], const Modulus& M,
                                    uint32_t r[WORDS]) {
  uint32_t X[WORDS + 1], Y[WORDS];
  // row 0: the products alone; within X (or Y) they do not overlap
#pragma unroll
  for (int j = 0; j < WORDS; j += 2) {
    asm("mul.lo.u32 %0, %4, %6;\n\t"
        "mul.hi.u32 %1, %4, %6;\n\t"
        "mul.lo.u32 %2, %5, %6;\n\t"
        "mul.hi.u32 %3, %5, %6;"
        : "=r"(X[j]), "=r"(X[j + 1]), "=r"(Y[j]), "=r"(Y[j + 1])
        : "r"(a[j]), "r"(a[j + 1]), "r"(b[0]));
  }
  X[WORDS] = 0;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    if (i > 0) {
      uint32_t Xn[WORDS + 1], Yn[WORDS];
      // shift, and Y = X[2..8] + a[odd] b[i]
      asm("add.cc.u32 %0, %9, %10;\n\t"
          "madc.lo.cc.u32 %1, %19, %23, %11;\n\t"
          "madc.hi.cc.u32 %2, %19, %23, %12;\n\t"
          "madc.lo.cc.u32 %3, %20, %23, %13;\n\t"
          "madc.hi.cc.u32 %4, %20, %23, %14;\n\t"
          "madc.lo.cc.u32 %5, %21, %23, %15;\n\t"
          "madc.hi.cc.u32 %6, %21, %23, %16;\n\t"
          "madc.lo.cc.u32 %7, %22, %23, %17;\n\t"
          "madc.hi.u32 %8, %22, %23, %18;"
          : "=r"(Xn[0]), "=r"(Yn[0]), "=r"(Yn[1]), "=r"(Yn[2]), "=r"(Yn[3]), "=r"(Yn[4]),
            "=r"(Yn[5]), "=r"(Yn[6]), "=r"(Yn[7])
          : "r"(Y[0]), "r"(X[1]), "r"(X[2]), "r"(X[3]), "r"(X[4]), "r"(X[5]), "r"(X[6]),
            "r"(X[7]), "r"(X[8]), "r"(0u), "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b[i]));
      // X = Y[1..7] (and the shifted word 0) + a[even] b[i]
      asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
          "madc.hi.cc.u32 %1, %9, %13, %14;\n\t"
          "madc.lo.cc.u32 %2, %10, %13, %15;\n\t"
          "madc.hi.cc.u32 %3, %10, %13, %16;\n\t"
          "madc.lo.cc.u32 %4, %11, %13, %17;\n\t"
          "madc.hi.cc.u32 %5, %11, %13, %18;\n\t"
          "madc.lo.cc.u32 %6, %12, %13, %19;\n\t"
          "madc.hi.cc.u32 %7, %12, %13, %20;\n\t"
          "addc.u32 %8, 0, 0;"
          : "+r"(Xn[0]), "=r"(Xn[1]), "=r"(Xn[2]), "=r"(Xn[3]), "=r"(Xn[4]), "=r"(Xn[5]),
            "=r"(Xn[6]), "=r"(Xn[7]), "=r"(Xn[8])
          : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b[i]), "r"(Y[1]), "r"(Y[2]),
            "r"(Y[3]), "r"(Y[4]), "r"(Y[5]), "r"(Y[6]), "r"(Y[7]));
#pragma unroll
      for (int k = 0; k < WORDS; ++k) Y[k] = Yn[k];
#pragma unroll
      for (int k = 0; k <= WORDS; ++k) X[k] = Xn[k];
    }
    const uint32_t m = X[0] * M.n0;
    // X += m p[even] (X[0] becomes 0), Y += m p[odd]: two independent chains
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(X[0]), "+r"(X[1]), "+r"(X[2]), "+r"(X[3]), "+r"(X[4]), "+r"(X[5]), "+r"(X[6]),
          "+r"(X[7]), "+r"(X[8])
        : "r"(m), "r"(M.p[0]), "r"(M.p[2]), "r"(M.p[4]), "r"(M.p[6]));
    asm("mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %8, %12, %6;\n\t"
        "madc.hi.u32 %7, %8, %12, %7;"
        : "+r"(Y[0]), "+r"(Y[1]), "+r"(Y[2]), "+r"(Y[3]), "+r"(Y[4]), "+r"(Y[5]), "+r"(Y[6]),
          "+r"(Y[7])
        : "r"(m), "r"(M.p[1]), "r"(M.p[3]), "r"(M.p[5]), "r"(M.p[7]));
  }
  // t / 2^32 = X[1..8] + Y, below 2p
  uint32_t t[WORDS], top;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(t[0]), "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]), "=r"(t[6]),
        "=r"(t[7]), "=r"(top)
      : "r"(X[1]), "r"(X[2]), "r"(X[3]), "r"(X[4]), "r"(X[5]), "r"(X[6]), "r"(X[7]), "r"(X[8]),
        "r"(Y[0]), "r"(Y[1]), "r"(Y[2]), "r"(Y[3]), "r"(Y[4]), "r"(Y[5]), "r"(Y[6]), "r"(Y[7]));
  reduce_once(t, top, M, r);
}

// Montgomery square r = a * a * 2^-256 mod p: the product of a with itself.
// An SOS square (28 cross products once, doubled, plus the diagonal) does
// fewer multiplies, but its rows overlap word by word, so they compile to
// the unfused form above; on one H100 it measured slower in both curve
// kernels (PERF.md).
__device__ __forceinline__ void sqr(const uint32_t a[WORDS], const Modulus& M, uint32_t r[WORDS]) {
  mul(a, a, M, r);
}

}  // namespace cc
}  // namespace h2t

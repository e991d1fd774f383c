// halo2_tpu native host engine — C++ counterpart of the Rust crates the
// reference leans on for sequential/host-side compute (halo2curves field +
// curve arithmetic, halo2_proofs poly ops; reference src/circuits/utils.rs
// pulls them in via create_proof, SURVEY.md §2c).  The TPU owns the
// large-batch data-parallel path (Pallas MSM/NTT); this engine owns the
// small-n / sequential tail where XLA program setup would dominate:
// per-commit MSMs at small k, NTTs, batch inversion, grand-product
// recurrences, Horner evaluations.
//
// Everything is BN254: Fr (scalar field) and Fq (base field of G1).
// ABI: 256-bit elements as 4 little-endian u64 limbs, arrays contiguous
// [elem0.l0, elem0.l1, ... elem0.l3, elem1.l0, ...].  Canonical (non-
// Montgomery) representation at the boundary unless a _mont entry is used.
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py); no deps.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstddef>
#include <algorithm>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX512IFMA__) && defined(__AVX512VL__)
#define H2T_IFMA 1
#include <immintrin.h>
#endif

using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

struct Fp4 {
  u64 l[4];
};

static inline bool fp_is_zero(const Fp4 &a) {
  return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0;
}

static inline bool fp_eq(const Fp4 &a, const Fp4 &b) {
  return a.l[0] == b.l[0] && a.l[1] == b.l[1] && a.l[2] == b.l[2] &&
         a.l[3] == b.l[3];
}

struct FieldCtx {
  Fp4 p;    // modulus
  u64 n0;   // -p^{-1} mod 2^64
  Fp4 r2;   // R^2 mod p (R = 2^256)
  Fp4 one;  // R mod p (Montgomery 1)
};

// ------------------------------------------------------------- constants
// BN254 Fr = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001
static const FieldCtx FR = {
    {{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL, 0xb85045b68181585dULL,
      0x30644e72e131a029ULL}},
    0xc2e1f593efffffffULL,
    {{0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL, 0x8c49833d53bb8085ULL,
      0x0216d0b17f4e44a5ULL}},
    {{0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL, 0x666ea36f7879462eULL,
      0x0e0a77c19a07df2fULL}},
};

// BN254 Fq = 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47
static const FieldCtx FQ = {
    {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL,
      0x30644e72e131a029ULL}},
    0x87d20782e4866389ULL,
    {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL, 0x47ab1eff0a417ff6ULL,
      0x06d89f71cab8351fULL}},
    {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL, 0x666ea36f7879462cULL,
      0x0e0a77c19a07df2fULL}},
};

// ------------------------------------------------------- field arithmetic
static inline void fp_add(const FieldCtx &F, const Fp4 &a, const Fp4 &b,
                          Fp4 &out) {
  u64 t[4];
  u64 carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)a.l[i] + b.l[i] + carry;
    t[i] = (u64)cur;
    carry = (u64)(cur >> 64);
  }
  // conditional subtract p (carry means t >= 2^256 > p, must subtract)
  u64 s[4];
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)t[i] - F.p.l[i] - borrow;
    s[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (carry || !borrow)
    memcpy(out.l, s, 32);
  else
    memcpy(out.l, t, 32);
}

static inline void fp_sub(const FieldCtx &F, const Fp4 &a, const Fp4 &b,
                          Fp4 &out) {
  u64 t[4];
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)a.l[i] - b.l[i] - borrow;
    t[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < 4; i++) {
      u128 cur = (u128)t[i] + F.p.l[i] + carry;
      t[i] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
  }
  memcpy(out.l, t, 32);
}

static inline void fp_neg(const FieldCtx &F, const Fp4 &a, Fp4 &out) {
  if (fp_is_zero(a)) {
    out = a;
    return;
  }
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)F.p.l[i] - a.l[i] - borrow;
    out.l[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
}

static void mul_wide(const Fp4 &a, const Fp4 &b, u64 t[8]) {
  memset(t, 0, 64);
  for (int i = 0; i < 4; i++) {
    u64 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 cur = (u128)a.l[i] * b.l[j] + t[i + j] + carry;
      t[i + j] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    t[i + 4] = carry;
  }
}

static void mont_reduce(const FieldCtx &F, u64 t[8], Fp4 &out) {
  for (int i = 0; i < 4; i++) {
    u64 m = t[i] * F.n0;
    u64 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 cur = (u128)m * F.p.l[j] + t[i + j] + carry;
      t[i + j] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
    for (int k = i + 4; carry && k < 8; k++) {
      u128 cur = (u128)t[k] + carry;
      t[k] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
  }
  // result in t[4..7]; 0 <= value < 2p, conditional subtract
  u64 s[4];
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)t[i + 4] - F.p.l[i] - borrow;
    s[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (!borrow)
    memcpy(out.l, s, 32);
  else
    memcpy(out.l, t + 4, 32);
}

// Fully-unrolled register-resident CIOS Montgomery multiply: every prover
// surface (MSM group law, NTT butterflies, expr VM) bottoms out here, and
// the loop/memory version above costs ~5x more cycles (profile: round 4).
#define MAC(hi, lo, a, b, c, d)                     \
  {                                                 \
    u128 _t = (u128)(a) * (b) + (c) + (d);          \
    (lo) = (u64)_t;                                 \
    (hi) = (u64)(_t >> 64);                         \
  }
#define ADC(hi, lo, a, b)              \
  {                                    \
    u128 _t = (u128)(a) + (b);         \
    (lo) = (u64)_t;                    \
    (hi) = (u64)(_t >> 64);            \
  }

static inline void fp_mul(const FieldCtx &F, const Fp4 &a, const Fp4 &b,
                          Fp4 &out) {
  const u64 *A = a.l, *B = b.l, *p = F.p.l;
  u64 t0, t1, t2, t3, t4;
  u64 c, c2, m, lo;

  // i = 0
  MAC(c, t0, A[0], B[0], 0, 0)
  MAC(c, t1, A[0], B[1], c, 0)
  MAC(c, t2, A[0], B[2], c, 0)
  MAC(c, t3, A[0], B[3], c, 0)
  t4 = c;
  m = t0 * F.n0;
  MAC(c, lo, m, p[0], t0, 0)
  MAC(c, t0, m, p[1], t1, c)
  MAC(c, t1, m, p[2], t2, c)
  MAC(c, t2, m, p[3], t3, c)
  ADC(c2, t3, t4, c)
  t4 = c2;

  // i = 1
  MAC(c, t0, A[1], B[0], t0, 0)
  MAC(c, t1, A[1], B[1], t1, c)
  MAC(c, t2, A[1], B[2], t2, c)
  MAC(c, t3, A[1], B[3], t3, c)
  ADC(c2, t4, t4, c)
  m = t0 * F.n0;
  MAC(c, lo, m, p[0], t0, 0)
  MAC(c, t0, m, p[1], t1, c)
  MAC(c, t1, m, p[2], t2, c)
  MAC(c, t2, m, p[3], t3, c)
  ADC(c, t3, t4, c)
  t4 = c2 + c;

  // i = 2
  MAC(c, t0, A[2], B[0], t0, 0)
  MAC(c, t1, A[2], B[1], t1, c)
  MAC(c, t2, A[2], B[2], t2, c)
  MAC(c, t3, A[2], B[3], t3, c)
  ADC(c2, t4, t4, c)
  m = t0 * F.n0;
  MAC(c, lo, m, p[0], t0, 0)
  MAC(c, t0, m, p[1], t1, c)
  MAC(c, t1, m, p[2], t2, c)
  MAC(c, t2, m, p[3], t3, c)
  ADC(c, t3, t4, c)
  t4 = c2 + c;

  // i = 3
  MAC(c, t0, A[3], B[0], t0, 0)
  MAC(c, t1, A[3], B[1], t1, c)
  MAC(c, t2, A[3], B[2], t2, c)
  MAC(c, t3, A[3], B[3], t3, c)
  ADC(c2, t4, t4, c)
  m = t0 * F.n0;
  MAC(c, lo, m, p[0], t0, 0)
  MAC(c, t0, m, p[1], t1, c)
  MAC(c, t1, m, p[2], t2, c)
  MAC(c, t2, m, p[3], t3, c)
  ADC(c, t3, t4, c)
  t4 = c2 + c;

  // t4 is 0 or 1; result t4*2^256 + t3..t0 < 2p: conditional subtract
  u64 s0, s1, s2, s3, borrow = 0;
  {
    u128 d = (u128)t0 - p[0];
    s0 = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  {
    u128 d = (u128)t1 - p[1] - borrow;
    s1 = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  {
    u128 d = (u128)t2 - p[2] - borrow;
    s2 = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  {
    u128 d = (u128)t3 - p[3] - borrow;
    s3 = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (t4 || !borrow) {
    out.l[0] = s0;
    out.l[1] = s1;
    out.l[2] = s2;
    out.l[3] = s3;
  } else {
    out.l[0] = t0;
    out.l[1] = t1;
    out.l[2] = t2;
    out.l[3] = t3;
  }
  (void)lo;
}

static inline void fp_sqr(const FieldCtx &F, const Fp4 &a, Fp4 &out) {
  fp_mul(F, a, a, out);
}

static inline void fp_from_mont(const FieldCtx &F, const Fp4 &a, Fp4 &out) {
  u64 t[8];
  memset(t, 0, 64);
  memcpy(t, a.l, 32);
  mont_reduce(F, t, out);
}

static inline void fp_to_mont(const FieldCtx &F, const Fp4 &a, Fp4 &out) {
  fp_mul(F, a, F.r2, out);
}

// a^e (Montgomery in/out); e canonical 4-limb
static void fp_pow(const FieldCtx &F, const Fp4 &a, const Fp4 &e, Fp4 &out) {
  Fp4 acc = F.one;
  Fp4 base = a;
  for (int w = 0; w < 4; w++) {
    u64 bits = e.l[w];
    for (int b = 0; b < 64; b++) {
      if (bits & 1) fp_mul(F, acc, base, acc);
      fp_sqr(F, base, base);
      bits >>= 1;
    }
  }
  out = acc;
}

// Montgomery inverse via Fermat (a^(p-2)); inv(0) = 0
static void fp_inv(const FieldCtx &F, const Fp4 &a, Fp4 &out) {
  Fp4 e = F.p;
  // e = p - 2 (p is odd and > 2, no borrow beyond limb 0)
  e.l[0] -= 2;
  fp_pow(F, a, e, out);
}

// ---- fast variable-time inverse (binary extended GCD) for the batched
// MSM inversion root (Fermat costs ~380 muls; this runs in ~2 us).  Input
// and output CANONICAL (not Montgomery).  Variable-time is acceptable here:
// the values inverted are Pippenger bucket x-deltas, already data-dependent
// through the (public-output) commitment pipeline; noted in NOTES_ROUND5.
static inline bool u256_is_zero(const Fp4 &a) { return fp_is_zero(a); }
static inline bool u256_is_even(const Fp4 &a) { return (a.l[0] & 1) == 0; }
static inline void u256_rshift1(Fp4 &a) {
  for (int i = 0; i < 3; i++) a.l[i] = (a.l[i] >> 1) | (a.l[i + 1] << 63);
  a.l[3] >>= 1;
}
static inline bool u256_gte(const Fp4 &a, const Fp4 &b) {
  for (int i = 3; i >= 0; i--) {
    if (a.l[i] != b.l[i]) return a.l[i] > b.l[i];
  }
  return true;
}
static inline void u256_sub_raw(Fp4 &a, const Fp4 &b) {  // a -= b (a >= b)
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)a.l[i] - b.l[i] - borrow;
    a.l[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
}

static void fp_inv_canon_vartime(const FieldCtx &F, const Fp4 &a_canon,
                                 Fp4 &out_canon) {
  if (fp_is_zero(a_canon)) {
    memset(out_canon.l, 0, 32);
    return;
  }
  Fp4 u = a_canon, v = F.p;
  Fp4 x1 = {{1, 0, 0, 0}}, x2 = {{0, 0, 0, 0}};
  auto mod_halve = [&](Fp4 &x) {
    if (u256_is_even(x)) {
      u256_rshift1(x);
    } else {
      // (x + p) / 2 with the carry bit folded into the shift
      u64 carry = 0;
      for (int i = 0; i < 4; i++) {
        u128 cur = (u128)x.l[i] + F.p.l[i] + carry;
        x.l[i] = (u64)cur;
        carry = (u64)(cur >> 64);
      }
      for (int i = 0; i < 3; i++) x.l[i] = (x.l[i] >> 1) | (x.l[i + 1] << 63);
      x.l[3] = (x.l[3] >> 1) | (carry << 63);
    }
  };
  auto mod_sub = [&](Fp4 &x, const Fp4 &y) {  // x = (x - y) mod p
    fp_sub(F, x, y, x);
  };
  while (!u256_is_zero(u) && !u256_is_zero(v)) {
    while (u256_is_even(u)) {
      u256_rshift1(u);
      mod_halve(x1);
    }
    while (u256_is_even(v)) {
      u256_rshift1(v);
      mod_halve(x2);
    }
    if (u256_gte(u, v)) {
      u256_sub_raw(u, v);
      mod_sub(x1, x2);
    } else {
      u256_sub_raw(v, u);
      mod_sub(x2, x1);
    }
  }
  out_canon = u256_is_zero(u) ? x2 : x1;
}

// ------------------------------------------------------------- G1 points
// Jacobian over Fq, Montgomery coords; inf flag explicit.
struct G1 {
  Fp4 X, Y, Z;
  bool inf;
};

static void g1_dbl(G1 &r, const G1 &p) {
  // dbl-2009-l (a=0); doubling a y=0 point -> infinity handled by Z=0 check
  if (p.inf) {
    r = p;
    return;
  }
  const FieldCtx &F = FQ;
  // r may alias p (acc = 2*acc in the Horner loop): compute every output
  // into temps before the first write to r.
  Fp4 A, B, C, D, E, Fv, t0, t1, x3, y3, z3;
  fp_sqr(F, p.X, A);
  fp_sqr(F, p.Y, B);
  fp_sqr(F, B, C);
  fp_add(F, p.X, B, t0);
  fp_sqr(F, t0, t0);
  fp_sub(F, t0, A, t0);
  fp_sub(F, t0, C, t0);
  fp_add(F, t0, t0, D);  // D = 2((X+B)^2 - A - C)
  fp_add(F, A, A, E);
  fp_add(F, E, A, E);  // E = 3A
  fp_sqr(F, E, Fv);
  fp_add(F, D, D, t0);
  fp_sub(F, Fv, t0, x3);  // X3 = F - 2D
  fp_sub(F, D, x3, t0);
  fp_mul(F, E, t0, t0);
  fp_add(F, C, C, t1);
  fp_add(F, t1, t1, t1);
  fp_add(F, t1, t1, t1);  // 8C
  fp_sub(F, t0, t1, y3);
  fp_mul(F, p.Y, p.Z, t0);
  fp_add(F, t0, t0, z3);
  r.X = x3;
  r.Y = y3;
  r.Z = z3;
  r.inf = fp_is_zero(z3);
}

// mixed add r = p + (x2, y2) (affine, never infinity)
static void g1_madd(G1 &r, const G1 &p, const Fp4 &x2, const Fp4 &y2) {
  const FieldCtx &F = FQ;
  if (p.inf) {
    r.X = x2;
    r.Y = y2;
    r.Z = F.one;
    r.inf = false;
    return;
  }
  Fp4 Z2, U2, S2, H, HH, I, J, rr, V, t0, t1;
  fp_sqr(F, p.Z, Z2);
  fp_mul(F, x2, Z2, U2);
  fp_mul(F, y2, p.Z, S2);
  fp_mul(F, S2, Z2, S2);
  fp_sub(F, U2, p.X, H);
  fp_sub(F, S2, p.Y, rr);
  if (fp_is_zero(H)) {
    if (fp_is_zero(rr)) {
      g1_dbl(r, p);
      return;
    }
    r.inf = true;
    return;
  }
  fp_add(F, rr, rr, rr);  // r = 2(S2 - Y1)
  fp_sqr(F, H, HH);
  fp_add(F, HH, HH, I);
  fp_add(F, I, I, I);  // I = 4HH
  fp_mul(F, H, I, J);
  fp_mul(F, p.X, I, V);
  fp_sqr(F, rr, t0);
  fp_sub(F, t0, J, t0);
  fp_add(F, V, V, t1);
  fp_sub(F, t0, t1, r.X);
  fp_sub(F, V, r.X, t0);
  fp_mul(F, rr, t0, t0);
  fp_mul(F, p.Y, J, t1);
  fp_add(F, t1, t1, t1);
  fp_sub(F, t0, t1, r.Y);
  fp_add(F, p.Z, H, t0);
  fp_sqr(F, t0, t0);
  fp_sub(F, t0, Z2, t0);
  fp_sub(F, t0, HH, r.Z);
  r.inf = fp_is_zero(r.Z);
}

// full Jacobian add r = p + q
static void g1_add(G1 &r, const G1 &p, const G1 &q) {
  const FieldCtx &F = FQ;
  if (p.inf) {
    r = q;
    return;
  }
  if (q.inf) {
    r = p;
    return;
  }
  Fp4 Z1Z1, Z2Z2, U1, U2, S1, S2, H, rr, I, J, V, t0, t1;
  fp_sqr(F, p.Z, Z1Z1);
  fp_sqr(F, q.Z, Z2Z2);
  fp_mul(F, p.X, Z2Z2, U1);
  fp_mul(F, q.X, Z1Z1, U2);
  fp_mul(F, p.Y, q.Z, S1);
  fp_mul(F, S1, Z2Z2, S1);
  fp_mul(F, q.Y, p.Z, S2);
  fp_mul(F, S2, Z1Z1, S2);
  fp_sub(F, U2, U1, H);
  fp_sub(F, S2, S1, rr);
  if (fp_is_zero(H)) {
    if (fp_is_zero(rr)) {
      g1_dbl(r, p);
      return;
    }
    r.inf = true;
    return;
  }
  fp_sqr(F, H, t0);
  fp_add(F, t0, t0, I);
  fp_add(F, I, I, I);  // I = 4H^2
  fp_mul(F, H, I, J);
  fp_add(F, rr, rr, rr);  // r = 2(S2-S1)
  fp_mul(F, U1, I, V);
  fp_sqr(F, rr, t0);
  fp_sub(F, t0, J, t0);
  fp_add(F, V, V, t1);
  fp_sub(F, t0, t1, r.X);
  fp_sub(F, V, r.X, t0);
  fp_mul(F, rr, t0, t0);
  fp_mul(F, S1, J, t1);
  fp_add(F, t1, t1, t1);
  fp_sub(F, t0, t1, r.Y);
  fp_mul(F, p.Z, q.Z, t0);
  fp_add(F, t0, t0, t0);
  fp_mul(F, t0, H, r.Z);
  r.inf = fp_is_zero(r.Z);
}

static int g_num_threads = 0;  // 0 = auto

static int num_threads() {
  if (g_num_threads > 0) return g_num_threads;
  unsigned h = std::thread::hardware_concurrency();
  return h ? (int)h : 1;
}

// --------------------------------------------------------------- Pippenger
// One window's bucket accumulation + suffix combine.
static void msm_window(const Fp4 *px_m, const Fp4 *py_m, const u64 *scalars,
                       size_t n, int c, int w, G1 &out) {
  const u64 mask = ((u64)1 << c) - 1;
  const int B = 1 << c;
  std::vector<G1> buckets(B - 1);
  for (auto &b : buckets) b.inf = true;
  const int bit0 = c * w;
  for (size_t e = 0; e < n; e++) {
    const int word = bit0 >> 6, off = bit0 & 63;
    u64 d = scalars[4 * e + word] >> off;
    if (off + c > 64 && word + 1 < 4) d |= scalars[4 * e + word + 1] << (64 - off);
    d &= mask;
    if (d == 0) continue;
    if (fp_is_zero(px_m[e]) && fp_is_zero(py_m[e])) continue;  // infinity
    g1_madd(buckets[d - 1], buckets[d - 1], px_m[e], py_m[e]);
  }
  // sum_d d * bucket[d] via running suffix sums
  G1 run, tot;
  run.inf = true;
  tot.inf = true;
  for (int d = B - 2; d >= 0; d--) {
    g1_add(run, run, buckets[d]);
    g1_add(tot, tot, run);
  }
  out = tot;
}

static void msm_impl(const Fp4 *px_m, const Fp4 *py_m, const u64 *scalars,
                     size_t n, G1 &result) {
  int c;
  if (n < 32)
    c = 3;
  else {
    int lg = 0;
    while (((size_t)1 << lg) < n) lg++;
    c = lg - 3;
    if (c < 4) c = 4;
    if (c > 16) c = 16;
  }
  const int W = (254 + c - 1) / c;
  std::vector<G1> wins(W);
  int nt = num_threads();
  if (nt > W) nt = W;
  if (nt <= 1 || n < 256) {
    for (int w = 0; w < W; w++) msm_window(px_m, py_m, scalars, n, c, w, wins[w]);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) {
      threads.emplace_back([&, t]() {
        for (int w = t; w < W; w += nt)
          msm_window(px_m, py_m, scalars, n, c, w, wins[w]);
      });
    }
    for (auto &th : threads) th.join();
  }
  // Horner combine: acc = sum 2^{cw} wins[w]
  G1 acc;
  acc.inf = true;
  for (int w = W - 1; w >= 0; w--) {
    for (int b = 0; b < c; b++) g1_dbl(acc, acc);
    g1_add(acc, acc, wins[w]);
  }
  result = acc;
}

// --------------------------------------------------------------- NTT (Fr)
static void bit_reverse(Fp4 *a, size_t n) {
  int bits = 0;
  while (((size_t)1 << bits) < n) bits++;
  for (size_t i = 0; i < n; i++) {
    size_t r = 0;
    for (int b = 0; b < bits; b++) r |= ((i >> b) & 1) << (bits - 1 - b);
    if (r > i) {
      Fp4 t = a[i];
      a[i] = a[r];
      a[r] = t;
    }
  }
}

// BN254 Fr root of unity: generator 7, two-adicity 28.
static void root_of_unity(size_t n, bool inverse, Fp4 &omega_m) {
  const FieldCtx &F = FR;
  // omega = 7^((p-1)/2^28) ^ (2^28 / n); exponent e = (p-1)/n
  // compute e = (p-1)/n as 4-limb: p-1 then shift right log2(n)
  Fp4 e = F.p;
  e.l[0] -= 1;
  int lg = 0;
  while (((size_t)1 << lg) < n) lg++;
  for (int s = 0; s < lg; s++) {
    for (int i = 0; i < 3; i++) e.l[i] = (e.l[i] >> 1) | (e.l[i + 1] << 63);
    e.l[3] >>= 1;
  }
  Fp4 g = {{7, 0, 0, 0}};
  fp_to_mont(F, g, g);
  fp_pow(F, g, e, omega_m);
  if (inverse) fp_inv(F, omega_m, omega_m);
}

// in-place NTT over Montgomery values, natural order in/out (DIT after
// bit-reversal) — identical butterfly schedule to poly/domain.py's _ntt_raw
static void ntt_mont(Fp4 *a, size_t n, bool inverse) {
  const FieldCtx &F = FR;
  Fp4 omega;
  root_of_unity(n, inverse, omega);
  bit_reverse(a, n);
  for (size_t m = 1; m < n; m <<= 1) {
    // w_stage = omega^(n/(2m))
    Fp4 ws = omega;
    for (size_t s = n / (2 * m); s > 1; s >>= 1) fp_sqr(F, ws, ws);
    std::vector<Fp4> tw(m);
    tw[0] = F.one;
    for (size_t j = 1; j < m; j++) fp_mul(F, tw[j - 1], ws, tw[j]);
    for (size_t g = 0; g < n; g += 2 * m) {
      for (size_t j = 0; j < m; j++) {
        Fp4 lo = a[g + j], hi;
        fp_mul(F, a[g + m + j], tw[j], hi);
        fp_add(F, lo, hi, a[g + j]);
        fp_sub(F, lo, hi, a[g + m + j]);
      }
    }
  }
  if (inverse) {
    // multiply by n^{-1}
    Fp4 ninv = {{(u64)n, 0, 0, 0}};
    fp_to_mont(F, ninv, ninv);
    fp_inv(F, ninv, ninv);
    for (size_t i = 0; i < n; i++) fp_mul(F, a[i], ninv, a[i]);
  }
}

static const FieldCtx &ctx_of(int field) { return field == 0 ? FR : FQ; }

// ------------------------------------------------------------ pairing tower
// BN254 optimal-ate pairing for the KZG verifier (reference verify_proof,
// src/circuits/utils.rs:56-63, runs halo2curves' native pairing; the Python
// fallback in ec/host.py costs ~2 s per verify on the naive final
// exponentiation).  Tower: Fq2 = Fq[i]/(i^2+1), Fq6 = Fq2[v]/(v^3 - xi)
// with xi = 9 + i, Fq12 = Fq6[w]/(w^2 - v).  Same field as ec/host.py's
// direct basis (w^6 = xi gives w^12 - 18 w^6 + 82 = 0); the Miller loop is
// the same affine construction, so results agree exactly.

struct Fq2 {
  Fp4 c0, c1;  // c0 + c1*i, components Montgomery
};

static inline void fq2_add(const Fq2 &a, const Fq2 &b, Fq2 &o) {
  fp_add(FQ, a.c0, b.c0, o.c0);
  fp_add(FQ, a.c1, b.c1, o.c1);
}
static inline void fq2_sub(const Fq2 &a, const Fq2 &b, Fq2 &o) {
  fp_sub(FQ, a.c0, b.c0, o.c0);
  fp_sub(FQ, a.c1, b.c1, o.c1);
}
static inline void fq2_neg(const Fq2 &a, Fq2 &o) {
  fp_neg(FQ, a.c0, o.c0);
  fp_neg(FQ, a.c1, o.c1);
}
static inline void fq2_conj(const Fq2 &a, Fq2 &o) {
  o.c0 = a.c0;
  fp_neg(FQ, a.c1, o.c1);
}
static inline void fq2_mul(const Fq2 &a, const Fq2 &b, Fq2 &o) {
  Fp4 t0, t1, t2, t3;
  fp_mul(FQ, a.c0, b.c0, t0);
  fp_mul(FQ, a.c1, b.c1, t1);
  fp_mul(FQ, a.c0, b.c1, t2);
  fp_mul(FQ, a.c1, b.c0, t3);
  fp_sub(FQ, t0, t1, o.c0);  // a0b0 - a1b1
  fp_add(FQ, t2, t3, o.c1);  // a0b1 + a1b0
}
static inline void fq2_sqr(const Fq2 &a, Fq2 &o) { fq2_mul(a, a, o); }
static inline void fq2_mul_fp(const Fq2 &a, const Fp4 &s, Fq2 &o) {
  fp_mul(FQ, a.c0, s, o.c0);
  fp_mul(FQ, a.c1, s, o.c1);
}
static inline bool fq2_is_zero(const Fq2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool fq2_eq(const Fq2 &a, const Fq2 &b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}
static inline void fq2_inv(const Fq2 &a, Fq2 &o) {
  // 1/(c0 + c1 i) = (c0 - c1 i) / (c0^2 + c1^2)
  Fp4 t0, t1, d;
  fp_sqr(FQ, a.c0, t0);
  fp_sqr(FQ, a.c1, t1);
  fp_add(FQ, t0, t1, d);
  fp_inv(FQ, d, d);
  fp_mul(FQ, a.c0, d, o.c0);
  fp_mul(FQ, a.c1, d, t0);
  fp_neg(FQ, t0, o.c1);
}
// xi = 9 + i (the sextic non-residue of the tower)
static inline void fq2_mul_xi(const Fq2 &a, Fq2 &o) {
  // (9 a0 - a1) + (a0 + 9 a1) i, via shift-free repeated adds
  Fp4 a0x9, a1x9, t;
  fp_add(FQ, a.c0, a.c0, t);
  fp_add(FQ, t, t, t);
  fp_add(FQ, t, t, a0x9);
  fp_add(FQ, a0x9, a.c0, a0x9);  // 9 a0
  fp_add(FQ, a.c1, a.c1, t);
  fp_add(FQ, t, t, t);
  fp_add(FQ, t, t, a1x9);
  fp_add(FQ, a1x9, a.c1, a1x9);  // 9 a1
  Fp4 c0, c1;
  fp_sub(FQ, a0x9, a.c1, c0);
  fp_add(FQ, a.c0, a1x9, c1);
  o.c0 = c0;
  o.c1 = c1;
}

struct Fq6 {
  Fq2 c0, c1, c2;  // c0 + c1 v + c2 v^2
};

static inline void fq6_add(const Fq6 &a, const Fq6 &b, Fq6 &o) {
  fq2_add(a.c0, b.c0, o.c0);
  fq2_add(a.c1, b.c1, o.c1);
  fq2_add(a.c2, b.c2, o.c2);
}
static inline void fq6_sub(const Fq6 &a, const Fq6 &b, Fq6 &o) {
  fq2_sub(a.c0, b.c0, o.c0);
  fq2_sub(a.c1, b.c1, o.c1);
  fq2_sub(a.c2, b.c2, o.c2);
}
static inline void fq6_neg(const Fq6 &a, Fq6 &o) {
  fq2_neg(a.c0, o.c0);
  fq2_neg(a.c1, o.c1);
  fq2_neg(a.c2, o.c2);
}
static void fq6_mul(const Fq6 &a, const Fq6 &b, Fq6 &o) {
  Fq2 a0b0, a1b1, a2b2, t0, t1, t2;
  fq2_mul(a.c0, b.c0, a0b0);
  fq2_mul(a.c1, b.c1, a1b1);
  fq2_mul(a.c2, b.c2, a2b2);
  // c0 = a0b0 + xi (a1b2 + a2b1)
  fq2_mul(a.c1, b.c2, t0);
  fq2_mul(a.c2, b.c1, t1);
  fq2_add(t0, t1, t0);
  fq2_mul_xi(t0, t0);
  Fq2 c0, c1, c2;
  fq2_add(a0b0, t0, c0);
  // c1 = a0b1 + a1b0 + xi a2b2
  fq2_mul(a.c0, b.c1, t0);
  fq2_mul(a.c1, b.c0, t1);
  fq2_add(t0, t1, t0);
  fq2_mul_xi(a2b2, t2);
  fq2_add(t0, t2, c1);
  // c2 = a0b2 + a1b1 + a2b0
  fq2_mul(a.c0, b.c2, t0);
  fq2_mul(a.c2, b.c0, t1);
  fq2_add(t0, t1, t0);
  fq2_add(t0, a1b1, c2);
  o.c0 = c0;
  o.c1 = c1;
  o.c2 = c2;
}
// multiply by v: (c0, c1, c2) -> (xi c2, c0, c1)
static inline void fq6_mul_v(const Fq6 &a, Fq6 &o) {
  Fq2 t;
  fq2_mul_xi(a.c2, t);
  o.c2 = a.c1;
  o.c1 = a.c0;
  o.c0 = t;
}
static void fq6_inv(const Fq6 &a, Fq6 &o) {
  // standard v^3 = xi tower inversion
  Fq2 t0, t1, t2, d, tmp;
  fq2_sqr(a.c0, t0);
  fq2_mul(a.c1, a.c2, tmp);
  fq2_mul_xi(tmp, tmp);
  fq2_sub(t0, tmp, t0);  // t0 = c0^2 - xi c1 c2
  fq2_sqr(a.c2, t1);
  fq2_mul_xi(t1, t1);
  fq2_mul(a.c0, a.c1, tmp);
  fq2_sub(t1, tmp, t1);  // t1 = xi c2^2 - c0 c1
  fq2_sqr(a.c1, t2);
  fq2_mul(a.c0, a.c2, tmp);
  fq2_sub(t2, tmp, t2);  // t2 = c1^2 - c0 c2
  // d = c0 t0 + xi (c2 t1 + c1 t2)
  Fq2 s;
  fq2_mul(a.c2, t1, s);
  fq2_mul(a.c1, t2, tmp);
  fq2_add(s, tmp, s);
  fq2_mul_xi(s, s);
  fq2_mul(a.c0, t0, tmp);
  fq2_add(tmp, s, d);
  fq2_inv(d, d);
  fq2_mul(t0, d, o.c0);
  fq2_mul(t1, d, o.c1);
  fq2_mul(t2, d, o.c2);
}
static inline bool fq6_is_zero(const Fq6 &a) {
  return fq2_is_zero(a.c0) && fq2_is_zero(a.c1) && fq2_is_zero(a.c2);
}

struct Fq12 {
  Fq6 c0, c1;  // c0 + c1 w
};

static void fq12_mul(const Fq12 &a, const Fq12 &b, Fq12 &o) {
  Fq6 a0b0, a1b1, t0, t1;
  fq6_mul(a.c0, b.c0, a0b0);
  fq6_mul(a.c1, b.c1, a1b1);
  fq6_mul_v(a1b1, t0);
  Fq6 c0, c1;
  fq6_add(a0b0, t0, c0);  // a0b0 + v a1b1
  fq6_mul(a.c0, b.c1, t0);
  fq6_mul(a.c1, b.c0, t1);
  fq6_add(t0, t1, c1);
  o.c0 = c0;
  o.c1 = c1;
}
static inline void fq12_sqr(const Fq12 &a, Fq12 &o) { fq12_mul(a, a, o); }
static void fq12_inv(const Fq12 &a, Fq12 &o) {
  // 1/(a0 + a1 w) = (a0 - a1 w) / (a0^2 - v a1^2)
  Fq6 t0, t1, d;
  fq6_mul(a.c0, a.c0, t0);
  fq6_mul(a.c1, a.c1, t1);
  fq6_mul_v(t1, t1);
  fq6_sub(t0, t1, d);
  fq6_inv(d, d);
  fq6_mul(a.c0, d, o.c0);
  fq6_mul(a.c1, d, t0);
  fq6_neg(t0, o.c1);
}
static inline void fq12_one(Fq12 &o) {
  memset(&o, 0, sizeof(o));
  o.c0.c0.c0 = FQ.one;
}
static inline bool fq12_is_one(const Fq12 &a) {
  Fq12 one;
  fq12_one(one);
  return memcmp(&a, &one, sizeof(a)) == 0;
}

// ---- pairing constants (computed once: exponents are 4-limb divisions)
// divide a 4-limb big-endian-normalised value by a small constant
static void limbs_div_small(const Fp4 &a, u64 d, Fp4 &o) {
  u128 rem = 0;
  for (int i = 3; i >= 0; i--) {
    u128 cur = (rem << 64) | a.l[i];
    o.l[i] = (u64)(cur / d);
    rem = cur % d;
  }
}

struct PairingConsts {
  Fq2 xi;        // 9 + i (Montgomery)
  Fq2 cx, cy;    // xi^((p-1)/3), xi^((p-1)/2): twisted-point Frobenius
  Fp4 cx2, cy2;  // norms cx*conj(cx), cy*conj(cy) in Fq (for pi^2)
  Fp4 b3;        // 3 in Montgomery (G1 curve b) -- unused, kept for clarity
};

static void fq2_pow(const Fq2 &a, const Fp4 &e, Fq2 &o) {
  Fq2 acc, base = a;
  memset(&acc, 0, sizeof(acc));
  acc.c0 = FQ.one;
  for (int w = 0; w < 4; w++) {
    u64 bits = e.l[w];
    for (int b = 0; b < 64; b++) {
      if (bits & 1) fq2_mul(acc, base, acc);
      fq2_sqr(base, base);
      bits >>= 1;
    }
  }
  o = acc;
}

static const PairingConsts &pairing_consts() {
  static PairingConsts C;
  static bool init = false;
  if (!init) {
    Fp4 nine = {{9, 0, 0, 0}};
    fp_to_mont(FQ, nine, nine);
    C.xi.c0 = nine;
    C.xi.c1 = FQ.one;
    Fp4 pm1 = FQ.p;
    pm1.l[0] -= 1;  // p - 1 (p odd)
    Fp4 e3, e2;
    limbs_div_small(pm1, 3, e3);
    limbs_div_small(pm1, 2, e2);
    fq2_pow(C.xi, e3, C.cx);
    fq2_pow(C.xi, e2, C.cy);
    // cx2 = cx * conj(cx) = |cx|^2 in Fq; same for cy
    Fp4 t0, t1;
    fp_sqr(FQ, C.cx.c0, t0);
    fp_sqr(FQ, C.cx.c1, t1);
    fp_add(FQ, t0, t1, C.cx2);
    fp_sqr(FQ, C.cy.c0, t0);
    fp_sqr(FQ, C.cy.c1, t1);
    fp_add(FQ, t0, t1, C.cy2);
    init = true;
  }
  return C;
}

// ---- affine G2 (twisted curve) + sparse line into the Fq12 tower.
// Line through T, Q (twisted affine coords) evaluated at P = (xp, yp) in G1:
//   l = -yp + (m xp) w + (y1 - m x1) w^3        (slope m in Fq2)
// with w coefficients living at c1.c0 (w) and c1.c1 (w^3 = v w) of the
// tower; the vertical line (x2 == x1, y2 == -y1) is l = xp - x1 w^2
// (w^2 = v -> c0.c1).  Mirrors ec/host.py's _linefunc exactly.
struct G2A {
  Fq2 x, y;
  bool inf;
};

static void line_into(const Fq2 &m, const Fq2 &x1, const Fq2 &y1,
                      const Fp4 &xp_m, const Fp4 &yp_m, Fq12 &l) {
  memset(&l, 0, sizeof(l));
  Fp4 nyp;
  fp_neg(FQ, yp_m, nyp);
  l.c0.c0.c0 = nyp;                 // -yp
  fq2_mul_fp(m, xp_m, l.c1.c0);     // (m xp) w
  Fq2 t;
  fq2_mul(m, x1, t);
  fq2_sub(y1, t, l.c1.c1);          // (y1 - m x1) w^3
}

static void vline_into(const Fq2 &x1, const Fp4 &xp_m, Fq12 &l) {
  memset(&l, 0, sizeof(l));
  l.c0.c0.c0 = xp_m;                // xp
  fq2_neg(x1, l.c0.c1);             // - x1 w^2
}

// l(T, Q) evaluated at P; advances T <- T + Q.  Handles T == Q (tangent)
// and T == -Q (vertical) like ec/host.py's _linefunc / ec_add.
static void miller_step(G2A &t, const G2A &q, const Fp4 &xp_m,
                        const Fp4 &yp_m, Fq12 &l) {
  Fq2 m, num, den;
  if (!fq2_eq(t.x, q.x)) {
    fq2_sub(q.y, t.y, num);
    fq2_sub(q.x, t.x, den);
    fq2_inv(den, den);
    fq2_mul(num, den, m);
    line_into(m, t.x, t.y, xp_m, yp_m, l);
    // T = T + Q
    Fq2 x3, y3, tmp;
    fq2_sqr(m, x3);
    fq2_sub(x3, t.x, x3);
    fq2_sub(x3, q.x, x3);
    fq2_sub(t.x, x3, tmp);
    fq2_mul(m, tmp, y3);
    fq2_sub(y3, t.y, y3);
    t.x = x3;
    t.y = y3;
  } else if (fq2_eq(t.y, q.y)) {
    // tangent: m = 3 x^2 / (2 y)
    Fq2 x2;
    fq2_sqr(t.x, x2);
    fq2_add(x2, x2, num);
    fq2_add(num, x2, num);
    fq2_add(t.y, t.y, den);
    fq2_inv(den, den);
    fq2_mul(num, den, m);
    line_into(m, t.x, t.y, xp_m, yp_m, l);
    Fq2 x3, y3, tmp;
    fq2_sqr(m, x3);
    fq2_sub(x3, t.x, x3);
    fq2_sub(x3, t.x, x3);
    fq2_sub(t.x, x3, tmp);
    fq2_mul(m, tmp, y3);
    fq2_sub(y3, t.y, y3);
    t.x = x3;
    t.y = y3;
  } else {
    vline_into(t.x, xp_m, l);
    t.inf = true;  // T + (-T) = infinity (never hit mid-loop for order-r Q)
  }
}

// optimal-ate loop count 6u+2 = 2^64 + ATE_LOW (the MSB is consumed by
// initializing T = Q, as in ec/host.py's LOG_ATE_LOOP_COUNT=63 convention)
static const u64 ATE_LOW = 11347224129447541672ULL;

// Miller loop WITHOUT final exponentiation.  p / q given canonical affine;
// accumulates into f (caller chains multiple pairs before one final exp).
static void miller_accumulate(const Fp4 &px, const Fp4 &py, const Fq2 &qx,
                              const Fq2 &qy, Fq12 &f) {
  const PairingConsts &C = pairing_consts();
  Fp4 xp_m, yp_m;
  fp_to_mont(FQ, px, xp_m);
  fp_to_mont(FQ, py, yp_m);
  Fq2 qxm, qym;
  fp_to_mont(FQ, qx.c0, qxm.c0);
  fp_to_mont(FQ, qx.c1, qxm.c1);
  fp_to_mont(FQ, qy.c0, qym.c0);
  fp_to_mont(FQ, qy.c1, qym.c1);
  G2A q = {qxm, qym, false};
  G2A t = q;
  Fq12 l;
  for (int i = 63; i >= 0; i--) {
    fq12_sqr(f, f);
    miller_step(t, t, xp_m, yp_m, l);  // tangent (T == T path)
    fq12_mul(f, l, f);
    if ((ATE_LOW >> i) & 1) {
      miller_step(t, q, xp_m, yp_m, l);
      fq12_mul(f, l, f);
    }
  }
  // q1 = pi_p(Q): (conj(x) cx, conj(y) cy); nq2 = (x cx2, -(y cy2))
  G2A q1, nq2;
  Fq2 cj;
  fq2_conj(q.x, cj);
  fq2_mul(cj, C.cx, q1.x);
  fq2_conj(q.y, cj);
  fq2_mul(cj, C.cy, q1.y);
  q1.inf = false;
  fq2_mul_fp(q.x, C.cx2, nq2.x);
  fq2_mul_fp(q.y, C.cy2, nq2.y);
  fq2_neg(nq2.y, nq2.y);
  nq2.inf = false;
  miller_step(t, q1, xp_m, yp_m, l);
  fq12_mul(f, l, f);
  miller_step(t, nq2, xp_m, yp_m, l);
  fq12_mul(f, l, f);
}

// f^e for a word-array exponent (little-endian u64s, canonical)
static void fq12_pow_words(const Fq12 &a, const u64 *e, size_t nw, Fq12 &o) {
  Fq12 acc;
  fq12_one(acc);
  // left-to-right square-and-multiply (skip leading zero words)
  int top = (int)nw - 1;
  while (top >= 0 && e[top] == 0) top--;
  bool started = false;
  for (int w = top; w >= 0; w--) {
    for (int b = 63; b >= 0; b--) {
      if (started) fq12_sqr(acc, acc);
      if ((e[w] >> b) & 1) {
        if (!started) {
          acc = a;
          started = true;
        } else {
          fq12_mul(acc, a, acc);
        }
      }
    }
  }
  o = acc;
}

// ----------------------------------------------------- AVX512-IFMA fast path
// 8-lane radix-2^52 Montgomery arithmetic (vpmadd52luq/vpmadd52huq): the
// prover's bulk surfaces (coset NTT batch, quotient expr-VM, elementwise
// muls) are data-parallel over rows/columns, and IFMA runs 8 independent
// 5x52-limb CIOS multiplies per instruction stream — measured ~8x over the
// scalar 4x64 CIOS on this class of CPU.  Values are kept in Montgomery form
// with respect to R' = 2^260 and bounded < 2p between ops (the radix-52
// headroom makes <2p inputs safe: 4p^2 < R'p).  Scalar 4x64 paths remain the
// portable fallback (#ifndef H2T_IFMA).
#ifdef H2T_IFMA

namespace {

struct Ctx52 {
  u64 p[5], p2[5];   // p, 2p in radix-52
  u64 p4[5], p8[5];  // 4p, 8p (lazy-reduction offsets; fit: 8p < 2^260)
  u64 n0;            // -p^{-1} mod 2^52
  u64 r2[5];         // (2^260)^2 mod p -> to-Montgomery multiplier
  u64 one_plain[5];  // literal 1 (from-Montgomery multiplier)
};

static void to52(const Fp4 &a, u64 o[5]) {
  const u64 M = ((u64)1 << 52) - 1;
  o[0] = a.l[0] & M;
  o[1] = ((a.l[0] >> 52) | (a.l[1] << 12)) & M;
  o[2] = ((a.l[1] >> 40) | (a.l[2] << 24)) & M;
  o[3] = ((a.l[2] >> 28) | (a.l[3] << 36)) & M;
  o[4] = a.l[3] >> 16;
}

static void from52(const u64 a[5], Fp4 &o) {
  o.l[0] = a[0] | (a[1] << 52);
  o.l[1] = (a[1] >> 12) | (a[2] << 40);
  o.l[2] = (a[2] >> 24) | (a[3] << 28);
  o.l[3] = (a[3] >> 36) | (a[4] << 16);
}

static u64 inv52(u64 x) {  // x^{-1} mod 2^52 (x odd), Newton iteration
  u64 inv = x;
  for (int i = 0; i < 6; i++) inv *= 2 - x * inv;
  return inv & (((u64)1 << 52) - 1);
}

static void make_ctx52(const FieldCtx &F, Ctx52 &C) {
  to52(F.p, C.p);
  // 2p computed directly (p < 2^255 so 2p fits 256 bits)
  Fp4 p2_64;
  u64 carry = 0;
  for (int i = 0; i < 4; i++) {
    u64 v = (F.p.l[i] << 1) | carry;
    carry = F.p.l[i] >> 63;
    p2_64.l[i] = v;
  }
  to52(p2_64, C.p2);
  // 4p / 8p exceed 256 bits for BN254 Fq -> double in the 52-bit domain
  const u64 M52 = ((u64)1 << 52) - 1;
  u64 carry52 = 0;
  for (int i = 0; i < 5; i++) {
    u64 v = (C.p2[i] << 1) | carry52;
    carry52 = C.p2[i] >> 51;
    C.p4[i] = v & M52;
  }
  carry52 = 0;
  for (int i = 0; i < 5; i++) {
    u64 v = (C.p4[i] << 1) | carry52;
    carry52 = C.p4[i] >> 51;
    C.p8[i] = v & M52;
  }
  C.n0 = ((u64)0 - inv52(C.p[0])) & (((u64)1 << 52) - 1);
  // r2 = 2^520 mod p via repeated doubling (one-time)
  Fp4 v = {{1, 0, 0, 0}};
  for (int i = 0; i < 520; i++) fp_add(F, v, v, v);
  to52(v, C.r2);
  memset(C.one_plain, 0, sizeof(C.one_plain));
  C.one_plain[0] = 1;
}

static const Ctx52 &fr52() {
  static Ctx52 C;
  static bool init = false;
  if (!init) {
    make_ctx52(FR, C);
    init = true;
  }
  return C;
}

// 8 elements, limb-planar
struct V52 {
  __m512i l[5];
};

static inline __m512i bcast(u64 v) { return _mm512_set1_epi64((long long)v); }

#define MASK52 bcast(((u64)1 << 52) - 1)

// lanewise CIOS Montgomery multiply; inputs < 2p (52-bit limbs), output < 2p
static inline void v52_mul(const Ctx52 &C, const V52 &a, const V52 &b, V52 &o) {
  const __m512i mask = MASK52;
  const __m512i zero = _mm512_setzero_si512();
  const __m512i n0 = bcast(C.n0);
  __m512i p0 = bcast(C.p[0]), p1 = bcast(C.p[1]), p2 = bcast(C.p[2]),
          p3 = bcast(C.p[3]), p4 = bcast(C.p[4]);
  __m512i t0 = zero, t1 = zero, t2 = zero, t3 = zero, t4 = zero, t5 = zero;
  for (int i = 0; i < 5; i++) {
    __m512i ai = a.l[i];
    t0 = _mm512_madd52lo_epu64(t0, ai, b.l[0]);
    t1 = _mm512_madd52lo_epu64(t1, ai, b.l[1]);
    t2 = _mm512_madd52lo_epu64(t2, ai, b.l[2]);
    t3 = _mm512_madd52lo_epu64(t3, ai, b.l[3]);
    t4 = _mm512_madd52lo_epu64(t4, ai, b.l[4]);
    t1 = _mm512_madd52hi_epu64(t1, ai, b.l[0]);
    t2 = _mm512_madd52hi_epu64(t2, ai, b.l[1]);
    t3 = _mm512_madd52hi_epu64(t3, ai, b.l[2]);
    t4 = _mm512_madd52hi_epu64(t4, ai, b.l[3]);
    t5 = _mm512_madd52hi_epu64(t5, ai, b.l[4]);
    __m512i m = _mm512_and_si512(_mm512_madd52lo_epu64(zero, t0, n0), mask);
    t0 = _mm512_madd52lo_epu64(t0, m, p0);
    __m512i carry = _mm512_srli_epi64(t0, 52);
    t1 = _mm512_add_epi64(t1, carry);
    t1 = _mm512_madd52lo_epu64(t1, m, p1);
    t2 = _mm512_madd52lo_epu64(t2, m, p2);
    t3 = _mm512_madd52lo_epu64(t3, m, p3);
    t4 = _mm512_madd52lo_epu64(t4, m, p4);
    t1 = _mm512_madd52hi_epu64(t1, m, p0);
    t2 = _mm512_madd52hi_epu64(t2, m, p1);
    t3 = _mm512_madd52hi_epu64(t3, m, p2);
    t4 = _mm512_madd52hi_epu64(t4, m, p3);
    t5 = _mm512_madd52hi_epu64(t5, m, p4);
    t0 = t1;
    t1 = t2;
    t2 = t3;
    t3 = t4;
    t4 = t5;
    t5 = zero;
  }
  // carry-propagate accumulators (< ~2^56) to 52-bit limbs
  __m512i c;
  c = _mm512_srli_epi64(t0, 52);
  t0 = _mm512_and_si512(t0, mask);
  t1 = _mm512_add_epi64(t1, c);
  c = _mm512_srli_epi64(t1, 52);
  t1 = _mm512_and_si512(t1, mask);
  t2 = _mm512_add_epi64(t2, c);
  c = _mm512_srli_epi64(t2, 52);
  t2 = _mm512_and_si512(t2, mask);
  t3 = _mm512_add_epi64(t3, c);
  c = _mm512_srli_epi64(t3, 52);
  t3 = _mm512_and_si512(t3, mask);
  t4 = _mm512_add_epi64(t4, c);
  o.l[0] = t0;
  o.l[1] = t1;
  o.l[2] = t2;
  o.l[3] = t3;
  o.l[4] = t4;
}

// N-way interleaved CIOS multiply: the single-stream v52_mul is
// latency-bound on the serial m-reduction chain (~0.5 IPC measured); two or
// three independent streams interleave to fill the IFMA ports.  Same math
// and bounds as v52_mul.
template <int N>
static inline void v52_mul_n(const Ctx52 &C, const V52 *a, const V52 *b,
                             V52 *o) {
  const __m512i mask = MASK52;
  const __m512i zero = _mm512_setzero_si512();
  const __m512i n0 = bcast(C.n0);
  __m512i p0 = bcast(C.p[0]), p1 = bcast(C.p[1]), p2 = bcast(C.p[2]),
          p3 = bcast(C.p[3]), p4 = bcast(C.p[4]);
  __m512i t[N][6];
  for (int s = 0; s < N; s++)
    for (int j = 0; j < 6; j++) t[s][j] = zero;
  for (int i = 0; i < 5; i++) {
    __m512i m[N];
    for (int s = 0; s < N; s++) {
      __m512i ai = a[s].l[i];
      t[s][0] = _mm512_madd52lo_epu64(t[s][0], ai, b[s].l[0]);
      t[s][1] = _mm512_madd52lo_epu64(t[s][1], ai, b[s].l[1]);
      t[s][2] = _mm512_madd52lo_epu64(t[s][2], ai, b[s].l[2]);
      t[s][3] = _mm512_madd52lo_epu64(t[s][3], ai, b[s].l[3]);
      t[s][4] = _mm512_madd52lo_epu64(t[s][4], ai, b[s].l[4]);
      t[s][1] = _mm512_madd52hi_epu64(t[s][1], ai, b[s].l[0]);
      t[s][2] = _mm512_madd52hi_epu64(t[s][2], ai, b[s].l[1]);
      t[s][3] = _mm512_madd52hi_epu64(t[s][3], ai, b[s].l[2]);
      t[s][4] = _mm512_madd52hi_epu64(t[s][4], ai, b[s].l[3]);
      t[s][5] = _mm512_madd52hi_epu64(t[s][5], ai, b[s].l[4]);
      m[s] = _mm512_and_si512(_mm512_madd52lo_epu64(zero, t[s][0], n0), mask);
    }
    for (int s = 0; s < N; s++) {
      t[s][0] = _mm512_madd52lo_epu64(t[s][0], m[s], p0);
      __m512i carry = _mm512_srli_epi64(t[s][0], 52);
      t[s][1] = _mm512_add_epi64(t[s][1], carry);
      t[s][1] = _mm512_madd52lo_epu64(t[s][1], m[s], p1);
      t[s][2] = _mm512_madd52lo_epu64(t[s][2], m[s], p2);
      t[s][3] = _mm512_madd52lo_epu64(t[s][3], m[s], p3);
      t[s][4] = _mm512_madd52lo_epu64(t[s][4], m[s], p4);
      t[s][1] = _mm512_madd52hi_epu64(t[s][1], m[s], p0);
      t[s][2] = _mm512_madd52hi_epu64(t[s][2], m[s], p1);
      t[s][3] = _mm512_madd52hi_epu64(t[s][3], m[s], p2);
      t[s][4] = _mm512_madd52hi_epu64(t[s][4], m[s], p3);
      t[s][5] = _mm512_madd52hi_epu64(t[s][5], m[s], p4);
      t[s][0] = t[s][1];
      t[s][1] = t[s][2];
      t[s][2] = t[s][3];
      t[s][3] = t[s][4];
      t[s][4] = t[s][5];
      t[s][5] = zero;
    }
  }
  for (int s = 0; s < N; s++) {
    __m512i c;
    c = _mm512_srli_epi64(t[s][0], 52);
    o[s].l[0] = _mm512_and_si512(t[s][0], mask);
    t[s][1] = _mm512_add_epi64(t[s][1], c);
    c = _mm512_srli_epi64(t[s][1], 52);
    o[s].l[1] = _mm512_and_si512(t[s][1], mask);
    t[s][2] = _mm512_add_epi64(t[s][2], c);
    c = _mm512_srli_epi64(t[s][2], 52);
    o[s].l[2] = _mm512_and_si512(t[s][2], mask);
    t[s][3] = _mm512_add_epi64(t[s][3], c);
    c = _mm512_srli_epi64(t[s][3], 52);
    o[s].l[3] = _mm512_and_si512(t[s][3], mask);
    o[s].l[4] = _mm512_add_epi64(t[s][4], c);
  }
}

// N-way interleaved Montgomery SQUARING: the 5x5 product halves its cross
// terms (10 pairs computed once and doubled, plus 5 diagonals: 30 IFMA vs
// the multiply's 50), then the standard 5-round m*p reduction runs on the
// completed accumulator row.  Same output bound as v52_mul_n (ab/2^260 + p).
// Accumulator magnitudes: product limbs < 2^55.2 (<= 4 cross halves doubled
// + 2 diagonal halves), reduction adds < 10*2^52 -> < 2^55.8, safely u64.
template <int N>
static inline void v52_sqr_n(const Ctx52 &C, const V52 *a, V52 *o) {
  const __m512i mask = MASK52;
  const __m512i zero = _mm512_setzero_si512();
  const __m512i n0 = bcast(C.n0);
  __m512i p0 = bcast(C.p[0]), p1 = bcast(C.p[1]), p2 = bcast(C.p[2]),
          p3 = bcast(C.p[3]), p4 = bcast(C.p[4]);
  __m512i t[N][10];
  for (int s = 0; s < N; s++) {
    // cross products i < j
    for (int k = 0; k < 10; k++) t[s][k] = zero;
    for (int i = 0; i < 4; i++) {
      __m512i ai = a[s].l[i];
      for (int j = i + 1; j < 5; j++) {
        t[s][i + j] = _mm512_madd52lo_epu64(t[s][i + j], ai, a[s].l[j]);
        t[s][i + j + 1] = _mm512_madd52hi_epu64(t[s][i + j + 1], ai, a[s].l[j]);
      }
    }
    // double the cross part, then add diagonals
    for (int k = 1; k < 10; k++) t[s][k] = _mm512_add_epi64(t[s][k], t[s][k]);
    for (int i = 0; i < 5; i++) {
      __m512i ai = a[s].l[i];
      t[s][2 * i] = _mm512_madd52lo_epu64(t[s][2 * i], ai, ai);
      t[s][2 * i + 1] = _mm512_madd52hi_epu64(t[s][2 * i + 1], ai, ai);
    }
  }
  // Montgomery reduction, 5 rounds, interleaved across the N streams
  for (int r = 0; r < 5; r++) {
    __m512i m[N];
    for (int s = 0; s < N; s++)
      m[s] = _mm512_and_si512(_mm512_madd52lo_epu64(zero, t[s][r], n0), mask);
    for (int s = 0; s < N; s++) {
      t[s][r] = _mm512_madd52lo_epu64(t[s][r], m[s], p0);
      __m512i carry = _mm512_srli_epi64(t[s][r], 52);
      t[s][r + 1] = _mm512_add_epi64(t[s][r + 1], carry);
      t[s][r + 1] = _mm512_madd52lo_epu64(t[s][r + 1], m[s], p1);
      t[s][r + 2] = _mm512_madd52lo_epu64(t[s][r + 2], m[s], p2);
      t[s][r + 3] = _mm512_madd52lo_epu64(t[s][r + 3], m[s], p3);
      t[s][r + 4] = _mm512_madd52lo_epu64(t[s][r + 4], m[s], p4);
      t[s][r + 1] = _mm512_madd52hi_epu64(t[s][r + 1], m[s], p0);
      t[s][r + 2] = _mm512_madd52hi_epu64(t[s][r + 2], m[s], p1);
      t[s][r + 3] = _mm512_madd52hi_epu64(t[s][r + 3], m[s], p2);
      t[s][r + 4] = _mm512_madd52hi_epu64(t[s][r + 4], m[s], p3);
      t[s][r + 5] = _mm512_madd52hi_epu64(t[s][r + 5], m[s], p4);
    }
  }
  for (int s = 0; s < N; s++) {
    __m512i c;
    c = _mm512_srli_epi64(t[s][5], 52);
    o[s].l[0] = _mm512_and_si512(t[s][5], mask);
    t[s][6] = _mm512_add_epi64(t[s][6], c);
    c = _mm512_srli_epi64(t[s][6], 52);
    o[s].l[1] = _mm512_and_si512(t[s][6], mask);
    t[s][7] = _mm512_add_epi64(t[s][7], c);
    c = _mm512_srli_epi64(t[s][7], 52);
    o[s].l[2] = _mm512_and_si512(t[s][7], mask);
    t[s][8] = _mm512_add_epi64(t[s][8], c);
    c = _mm512_srli_epi64(t[s][8], 52);
    o[s].l[3] = _mm512_and_si512(t[s][8], mask);
    o[s].l[4] = _mm512_add_epi64(t[s][9], c);
  }
}

// conditional subtract of a 5x52 constant: o = (a >= k) ? a - k : a
static inline void v52_condsub(const u64 k[5], V52 &a) {
  const __m512i mask = MASK52;
  __m512i u[5], borrow = _mm512_setzero_si512();
  for (int i = 0; i < 5; i++) {
    __m512i d = _mm512_sub_epi64(a.l[i], _mm512_add_epi64(bcast(k[i]), borrow));
    borrow = _mm512_srli_epi64(d, 63);  // top bit set iff wrapped negative
    u[i] = _mm512_and_si512(d, mask);
  }
  __mmask8 keep = _mm512_cmpneq_epu64_mask(borrow, _mm512_setzero_si512());
  for (int i = 0; i < 5; i++)
    a.l[i] = _mm512_mask_blend_epi64(keep, u[i], a.l[i]);
}

// a + b (both < 2p) -> < 2p
static inline void v52_add(const Ctx52 &C, const V52 &a, const V52 &b, V52 &o) {
  const __m512i mask = MASK52;
  __m512i carry = _mm512_setzero_si512();
  for (int i = 0; i < 5; i++) {
    __m512i s = _mm512_add_epi64(_mm512_add_epi64(a.l[i], b.l[i]), carry);
    carry = _mm512_srli_epi64(s, 52);
    o.l[i] = _mm512_and_si512(s, mask);
  }
  v52_condsub(C.p2, o);
}

// a - b (both < 2p) -> < 2p  (computed as a + 2p - b, then cond-sub 2p)
static inline void v52_sub(const Ctx52 &C, const V52 &a, const V52 &b, V52 &o) {
  const __m512i mask = MASK52;
  __m512i carry = _mm512_setzero_si512();
  for (int i = 0; i < 5; i++) {
    // a + 2p >= b limb-by-limb with borrow folded into the carry chain
    __m512i s = _mm512_add_epi64(_mm512_add_epi64(a.l[i], bcast(C.p2[i])), carry);
    s = _mm512_sub_epi64(s, b.l[i]);
    // s in (-2^52, 2^53): arithmetic shift gives -1 borrow or 0/1 carry
    carry = _mm512_srai_epi64(s, 52);
    o.l[i] = _mm512_and_si512(s, mask);
  }
  v52_condsub(C.p2, o);
}

// ---- lazy-reduction variants (no trailing conditional subtract).  The
// radix-52 representation holds values < 2^260 ~ 84.7p, so Jacobian-formula
// intermediates may drift well past 2p between multiplies; the Montgomery
// multiply itself compresses k*p inputs back to (k^2*0.0118 + 1)p.  Interval
// analysis for the madd lives at j52_madd_n.

// o = a + b, no reduction (caller guarantees a + b < 2^260)
static inline void v52_add_lazy(const V52 &a, const V52 &b, V52 &o) {
  const __m512i mask = MASK52;
  __m512i carry = _mm512_setzero_si512();
  for (int i = 0; i < 5; i++) {
    __m512i s = _mm512_add_epi64(_mm512_add_epi64(a.l[i], b.l[i]), carry);
    carry = _mm512_srli_epi64(s, 52);
    o.l[i] = _mm512_and_si512(s, mask);
  }
}

// o = a + k - b where k (a precomputed K*p) bounds b from above
static inline void v52_sub_lazy(const u64 k[5], const V52 &a, const V52 &b,
                                V52 &o) {
  const __m512i mask = MASK52;
  __m512i carry = _mm512_setzero_si512();
  for (int i = 0; i < 5; i++) {
    __m512i s = _mm512_add_epi64(_mm512_add_epi64(a.l[i], bcast(k[i])), carry);
    s = _mm512_sub_epi64(s, b.l[i]);
    carry = _mm512_srai_epi64(s, 52);
    o.l[i] = _mm512_and_si512(s, mask);
  }
}

static inline void v52_neg(const Ctx52 &C, const V52 &a, V52 &o) {
  const __m512i mask = MASK52;
  __m512i borrow = _mm512_setzero_si512();
  for (int i = 0; i < 5; i++) {
    __m512i d = _mm512_sub_epi64(bcast(C.p2[i]), _mm512_add_epi64(a.l[i], borrow));
    borrow = _mm512_srli_epi64(d, 63);
    o.l[i] = _mm512_and_si512(d, mask);
  }
  v52_condsub(C.p2, o);
}

// plain repack of 8 canonical elements into 52-bit lanes (no Montgomery)
static inline void v52_pack8(const Fp4 *src, V52 &o) {
  alignas(64) u64 lanes[5][8];
  for (int e = 0; e < 8; e++) {
    u64 t[5];
    to52(src[e], t);
    for (int i = 0; i < 5; i++) lanes[i][e] = t[i];
  }
  for (int i = 0; i < 5; i++)
    o.l[i] = _mm512_load_si512((const void *)lanes[i]);
}

static inline void v52_unpack8(const V52 &a, Fp4 *dst) {
  alignas(64) u64 lanes[5][8];
  for (int i = 0; i < 5; i++) _mm512_store_si512((void *)lanes[i], a.l[i]);
  for (int e = 0; e < 8; e++) {
    u64 t[5] = {lanes[0][e], lanes[1][e], lanes[2][e], lanes[3][e], lanes[4][e]};
    from52(t, dst[e]);
  }
}

// 2-block canonical -> Montgomery-52 (one interleaved double multiply)
static inline void v52_load_mont2(const Ctx52 &C, const Fp4 *s0, const Fp4 *s1,
                                  V52 &o0, V52 &o1) {
  V52 a[2], b[2], o[2];
  v52_pack8(s0, a[0]);
  v52_pack8(s1, a[1]);
  for (int i = 0; i < 5; i++) b[0].l[i] = b[1].l[i] = bcast(C.r2[i]);
  v52_mul_n<2>(C, a, b, o);
  o0 = o[0];
  o1 = o[1];
}

// 2-block Montgomery-52 -> canonical (exact)
static inline void v52_store_canon2(const Ctx52 &C, const V52 &a0,
                                    const V52 &a1, Fp4 *d0, Fp4 *d1) {
  V52 a[2] = {a0, a1}, b[2], o[2];
  for (int i = 0; i < 5; i++) b[0].l[i] = b[1].l[i] = bcast(C.one_plain[i]);
  v52_mul_n<2>(C, a, b, o);
  v52_condsub(C.p, o[0]);
  v52_condsub(C.p, o[1]);
  v52_unpack8(o[0], d0);
  v52_unpack8(o[1], d1);
}

// load 8 canonical (4x64) elements -> Montgomery 52 (multiply by r2)
static inline void v52_load_mont(const Ctx52 &C, const Fp4 *src, V52 &o) {
  alignas(64) u64 lanes[5][8];
  for (int e = 0; e < 8; e++) {
    u64 t[5];
    to52(src[e], t);
    for (int i = 0; i < 5; i++) lanes[i][e] = t[i];
  }
  V52 plain;
  for (int i = 0; i < 5; i++)
    plain.l[i] = _mm512_load_si512((const void *)lanes[i]);
  V52 r2v;
  for (int i = 0; i < 5; i++) r2v.l[i] = bcast(C.r2[i]);
  v52_mul(C, plain, r2v, o);
}

// store Montgomery 52 -> 8 canonical (4x64) elements (fully reduced)
static inline void v52_store_canon(const Ctx52 &C, const V52 &a, Fp4 *dst) {
  V52 onev, r;
  for (int i = 0; i < 5; i++) onev.l[i] = bcast(C.one_plain[i]);
  v52_mul(C, a, onev, r);  // < 2p and ~< 1.05p; two cond-subs make it exact
  v52_condsub(C.p, r);
  alignas(64) u64 lanes[5][8];
  for (int i = 0; i < 5; i++)
    _mm512_store_si512((void *)lanes[i], r.l[i]);
  for (int e = 0; e < 8; e++) {
    u64 t[5] = {lanes[0][e], lanes[1][e], lanes[2][e], lanes[3][e], lanes[4][e]};
    from52(t, dst[e]);
  }
}

// broadcast one scalar Montgomery-52 element to all lanes
static inline void v52_bcast_elem(const u64 m52[5], V52 &o) {
  for (int i = 0; i < 5; i++) o.l[i] = bcast(m52[i]);
}

// scalar (1-lane) canonical -> Montgomery-52 (Fr only; setup-time cost).
// fp_to_mont gives canon*2^256 mod p as a plain 4x64 value; four modular
// doublings reach canon*2^260 mod p — the Montgomery-52 representative.
static void scalar_to_mont52(const Ctx52 &C, const Fp4 &canon, u64 o[5]) {
  (void)C;
  Fp4 m;
  fp_to_mont(FR, canon, m);
  for (int i = 0; i < 4; i++) fp_add(FR, m, m, m);
  to52(m, o);
}

// ---------------------------------------------- IFMA NTT over column blocks
// Vectorizes ACROSS COLUMNS (8 per block): every stage's butterfly schedule
// is identical for all columns, twiddles broadcast, no gathers at any stage.
// Twiddle tables (Montgomery-52 scalars, n-1 entries) are cached per
// (n, inverse) and shared by every column/thread.

struct TwiddleTable {
  std::vector<u64> tw;  // stage-major: for m = 1,2,4,..: m entries of 5 u64
  u64 ninv[5];          // n^{-1} Montgomery-52 (inverse transforms)
};

static std::map<std::pair<size_t, int>, TwiddleTable> g_twiddles;
static std::mutex g_twiddles_mu;

static const TwiddleTable &twiddle_table(size_t n, bool inverse) {
  std::lock_guard<std::mutex> lock(g_twiddles_mu);
  auto key = std::make_pair(n, inverse ? 1 : 0);
  auto it = g_twiddles.find(key);
  if (it != g_twiddles.end()) return it->second;
  TwiddleTable &T = g_twiddles[key];
  const Ctx52 &C = fr52();
  Fp4 omega;
  root_of_unity(n, inverse, omega);  // Montgomery 4x64
  T.tw.reserve(5 * (n - 1));
  for (size_t m = 1; m < n; m <<= 1) {
    Fp4 ws = omega;
    for (size_t s = n / (2 * m); s > 1; s >>= 1) fp_sqr(FR, ws, ws);
    Fp4 cur = FR.one;
    for (size_t j = 0; j < m; j++) {
      Fp4 canon;
      fp_from_mont(FR, cur, canon);
      u64 m52[5];
      scalar_to_mont52(C, canon, m52);
      for (int i = 0; i < 5; i++) T.tw.push_back(m52[i]);
      fp_mul(FR, cur, ws, cur);
    }
  }
  Fp4 ninv = {{(u64)n, 0, 0, 0}};
  fp_to_mont(FR, ninv, ninv);
  fp_inv(FR, ninv, ninv);
  Fp4 canon;
  fp_from_mont(FR, ninv, canon);
  scalar_to_mont52(C, canon, T.ninv);
  return T;
}

// in-place NTT on a planar block buf[n] of V52 (Montgomery-52, natural in/out)
static void ntt_ifma_block(V52 *buf, size_t n, bool inverse) {
  const Ctx52 &C = fr52();
  const TwiddleTable &T = twiddle_table(n, inverse);
  // bit-reverse permutation of whole vectors
  int bits = 0;
  while (((size_t)1 << bits) < n) bits++;
  for (size_t i = 0; i < n; i++) {
    size_t r = 0;
    for (int b = 0; b < bits; b++) r |= ((i >> b) & 1) << (bits - 1 - b);
    if (r > i) {
      V52 t = buf[i];
      buf[i] = buf[r];
      buf[r] = t;
    }
  }
  const u64 *twp = T.tw.data();
  const size_t half = n >> 1;
  for (size_t m = 1; m < n; m <<= 1) {
    // flat butterfly index k: group g = (k/m)*2m, twiddle j = k mod m;
    // consecutive k are independent -> interleave pairs of twiddle muls
    size_t k = 0;
    for (; k + 2 <= half; k += 2) {
      size_t j0 = k & (m - 1), i0 = ((k & ~(m - 1)) << 1) | j0;
      size_t k1 = k + 1;
      size_t j1 = k1 & (m - 1), i1 = ((k1 & ~(m - 1)) << 1) | j1;
      V52 a2[2], b2[2], hi2[2];
      v52_bcast_elem(twp + 5 * j0, b2[0]);
      v52_bcast_elem(twp + 5 * j1, b2[1]);
      a2[0] = buf[i0 + m];
      a2[1] = buf[i1 + m];
      v52_mul_n<2>(C, a2, b2, hi2);
      V52 lo0 = buf[i0], lo1 = buf[i1];
      v52_add(C, lo0, hi2[0], buf[i0]);
      v52_sub(C, lo0, hi2[0], buf[i0 + m]);
      v52_add(C, lo1, hi2[1], buf[i1]);
      v52_sub(C, lo1, hi2[1], buf[i1 + m]);
    }
    for (; k < half; k++) {
      size_t j0 = k & (m - 1), i0 = ((k & ~(m - 1)) << 1) | j0;
      V52 w, hi, lo = buf[i0];
      v52_bcast_elem(twp + 5 * j0, w);
      v52_mul(C, buf[i0 + m], w, hi);
      v52_add(C, lo, hi, buf[i0]);
      v52_sub(C, lo, hi, buf[i0 + m]);
    }
    twp += 5 * m;
  }
  if (inverse) {
    V52 ninv;
    v52_bcast_elem(T.ninv, ninv);
    size_t i = 0;
    for (; i + 2 <= n; i += 2) {
      V52 a2[2] = {buf[i], buf[i + 1]}, b2[2] = {ninv, ninv}, o2[2];
      v52_mul_n<2>(C, a2, b2, o2);
      buf[i] = o2[0];
      buf[i + 1] = o2[1];
    }
    for (; i < n; i++) v52_mul(C, buf[i], ninv, buf[i]);
  }
}

static const Ctx52 &fq52() {
  static Ctx52 C;
  static bool init = false;
  if (!init) {
    make_ctx52(FQ, C);
    init = true;
  }
  return C;
}

// zero mod p in [0, 2p) has representatives {0, p}
static inline __mmask8 v52_is_zero(const Ctx52 &C, const V52 &a) {
  __m512i or_all = a.l[0];
  __mmask8 eq_p = _mm512_cmpeq_epu64_mask(a.l[0], bcast(C.p[0]));
  for (int i = 1; i < 5; i++) {
    or_all = _mm512_or_si512(or_all, a.l[i]);
    eq_p &= _mm512_cmpeq_epu64_mask(a.l[i], bcast(C.p[i]));
  }
  return _mm512_cmpeq_epu64_mask(or_all, _mm512_setzero_si512()) | eq_p;
}

static inline __mmask8 v52_eq(const Ctx52 &C, const V52 &a, const V52 &b) {
  // equality of residues in [0, 2p): a - b is zero mod p
  V52 d;
  v52_sub(C, a, b, d);
  return v52_is_zero(C, d);
}

static inline void v52_select(__mmask8 m, const V52 &yes, const V52 &no, V52 &o) {
  for (int i = 0; i < 5; i++) o.l[i] = _mm512_mask_blend_epi64(m, no.l[i], yes.l[i]);
}

// ---- lane <-> scalar conversions for the rare exceptional-case fallbacks
// mont52 repr (x * 2^260 mod p, in [0,2p)) -> 4x64 Montgomery (x * 2^256)
static void lane_to_mont64(const FieldCtx &F, const u64 v52v[5], Fp4 &o) {
  Fp4 v;
  // v may be in [0, 8p) under the lazy-reduction invariant, and 8p > 2^256
  // overflows the 4x64 fold (from52 drops bits 256+).  Reduce to < p in the
  // 52-bit domain first (conditional 4p, 2p, p, p), THEN fold.
  u64 w[5];
  memcpy(w, v52v, 40);
  const Ctx52 &C52 = (&F == &FQ) ? fq52() : fr52();
  const u64 M = ((u64)1 << 52) - 1;
  for (const u64 *k : {C52.p4, C52.p2, C52.p, C52.p}) {
    u64 s[5], borrow = 0;
    for (int i = 0; i < 5; i++) {
      u64 d = w[i] - k[i] - borrow;
      borrow = (d >> 63) & 1;  // limbs < 2^52: top bit set iff wrapped
      s[i] = d & M;
    }
    if (!borrow) memcpy(w, s, 40);
  }
  from52(w, v);
  u64 s[4], borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 cur = (u128)v.l[i] - F.p.l[i] - borrow;
    s[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (!borrow) memcpy(v.l, s, 32);
  // v = x*2^260 mod p; halve 4 times (x odd -> add p first)
  for (int k = 0; k < 4; k++) {
    if (v.l[0] & 1) {
      u64 carry = 0;
      for (int i = 0; i < 4; i++) {
        u128 cur = (u128)v.l[i] + F.p.l[i] + carry;
        v.l[i] = (u64)cur;
        carry = (u64)(cur >> 64);
      }
      for (int i = 0; i < 3; i++) v.l[i] = (v.l[i] >> 1) | (v.l[i + 1] << 63);
      v.l[3] = (v.l[3] >> 1) | (carry << 63);
    } else {
      for (int i = 0; i < 3; i++) v.l[i] = (v.l[i] >> 1) | (v.l[i + 1] << 63);
      v.l[3] >>= 1;
    }
  }
  o = v;  // x * 2^256 mod p
}

// 4x64 Montgomery (x * 2^256) -> mont52 repr (x * 2^260 mod p)
static void mont64_to_lane(const FieldCtx &F, const Fp4 &m, u64 o[5]) {
  Fp4 v = m;
  for (int i = 0; i < 4; i++) fp_add(F, v, v, v);
  to52(v, o);
}

struct J52 {
  V52 X, Y, Z;  // Jacobian, infinity iff Z == 0 (mod p)
};

struct One52H {
  u64 v[5];
};

static const u64 *one52_fq() {
  static const One52H h = [] {
    One52H t;
    Fp4 o1 = {{1, 0, 0, 0}}, m;
    fp_to_mont(FQ, o1, m);
    mont64_to_lane(FQ, m, t.v);
    return t;
  }();
  return h.v;
}

static inline void j52_set_lane(J52 &p, int lane, const G1 &g) {
  // g: 4x64 Montgomery Jacobian (G1); write one lane
  const FieldCtx &F = FQ;
  u64 t[5];
  alignas(64) u64 tmp[8];
  const Fp4 *coords[3] = {&g.X, &g.Y, &g.Z};
  V52 *dst[3] = {&p.X, &p.Y, &p.Z};
  Fp4 zero = {{0, 0, 0, 0}};
  for (int cidx = 0; cidx < 3; cidx++) {
    if (g.inf)
      to52(zero, t);
    else
      mont64_to_lane(F, *coords[cidx], t);
    for (int i = 0; i < 5; i++) {
      _mm512_store_si512((void *)tmp, dst[cidx]->l[i]);
      tmp[lane] = t[i];
      dst[cidx]->l[i] = _mm512_load_si512((const void *)tmp);
    }
  }
}

static inline void j52_get_lane(const J52 &p, int lane, G1 &g) {
  const FieldCtx &F = FQ;
  alignas(64) u64 tmp[8];
  u64 t[5];
  const V52 *src[3] = {&p.X, &p.Y, &p.Z};
  Fp4 *coords[3] = {&g.X, &g.Y, &g.Z};
  for (int cidx = 0; cidx < 3; cidx++) {
    for (int i = 0; i < 5; i++) {
      _mm512_store_si512((void *)tmp, src[cidx]->l[i]);
      t[i] = tmp[lane];
    }
    lane_to_mont64(F, t, *coords[cidx]);
  }
  g.inf = fp_is_zero(g.Z);
  if (g.inf) {
    // canonicalize infinity for the scalar ops
    memset(&g.X, 0, 32);
    memset(&g.Z, 0, 32);
  }
}

// N independent mixed adds with every multiply paired ACROSS the streams
// (within one madd the multiplies sit on one dependency chain; across
// points they are independent, which is what actually fills the IFMA
// ports).  Same semantics as NS j52_madd calls on disjoint buckets.
// NS=2 measured ~1.5x one-at-a-time; NS=3 keeps v52_mul_n<3> inside the
// 32-zmm register file (t[3][6] + m[3] + 8 constants = 29 live regs).
//
// LAZY REDUCTION: bucket coordinates obey X, Y, Z < 8p (not < 2p); affine
// px/py are < p (mont64_to_lane output).  Adds/subs skip the conditional
// subtract entirely; the Montgomery multiply compresses (ka*p)(kb*p) inputs
// to (ka*kb*c + 1)p with c = p/2^260 = 0.0119 for BN254 Fq.  Interval walk
// (worst cases, c rounded up to 0.012):
//   z1z1=Z^2<1.8p  u2=px*z1z1<1.1p  t0=Z*z1z1<1.2p  h=u2+8p-X<9.1p
//   s2=py*t0<1.1p  hh=h^2<2.0p      i4=4hh<8.0p     j=h*i4<1.9p
//   v=X*i4<1.8p    r1=s2+8p-Y<9.1p  rr=2r1<18.2p    x3a=rr^2<5.0p
//   t1=Y*j<1.2p    x3b=x3a+2p-j<7p  x3c=x3b+4p-2v<11p --condsub8--> <8p
//   t0''=v+8p-x3<9.8p  y3a=rr*t0''<3.2p  y3=y3a+4p-2t1<7.2p
//   zh=Z*h<1.9p    z3=2zh<3.8p
// Max intermediate 18.2p = 0.22*2^260: limbs never overflow.  One condsub
// per madd (was 12) — the round-5 device-kernel carry-save idea, host-side.
// Exceptional lanes are detected on mul OUTPUTS (< 2p, so the {0, p}
// representative test stays valid): p_inf via z1z1, h==0 via hh, rr==0 via
// rr^2 reduced below 2p by two conditional subtracts.
template <int NS>
static void j52_madd_n(const Ctx52 &C, J52 *const *pp, const V52 *px,
                       const V52 *py, const __mmask8 *valid) {
  V52 z1z1[NS], u2[NS], s2[NS], h[NS], hh[NS], i4[NS], j[NS], r1[NS], rr[NS];
  V52 v[NS], t0[NS], t1[NS], x3[NS], y3[NS], z3[NS], a2[NS], b2[NS];
  __mmask8 p_inf_n[NS], h_zero_n[NS], r_zero_n[NS];
#define MULN(dst, sa, sb)              \
  {                                    \
    for (int s = 0; s < NS; s++) {     \
      a2[s] = (sa);                    \
      b2[s] = (sb);                    \
    }                                  \
    v52_mul_n<NS>(C, a2, b2, dst);     \
  }
#define SQRN(dst, sa)                  \
  {                                    \
    for (int s = 0; s < NS; s++) a2[s] = (sa); \
    v52_sqr_n<NS>(C, a2, dst);         \
  }
  SQRN(z1z1, pp[s]->Z)
  MULN(u2, px[s], z1z1[s])
  MULN(t0, pp[s]->Z, z1z1[s])
  MULN(s2, py[s], t0[s])
  for (int s = 0; s < NS; s++) {
    p_inf_n[s] = v52_is_zero(C, z1z1[s]);
    v52_sub_lazy(C.p8, u2[s], pp[s]->X, h[s]);
  }
  SQRN(hh, h[s])
  for (int s = 0; s < NS; s++) {
    h_zero_n[s] = v52_is_zero(C, hh[s]);
    v52_add_lazy(hh[s], hh[s], i4[s]);
    v52_add_lazy(i4[s], i4[s], i4[s]);
  }
  MULN(j, h[s], i4[s])
  MULN(v, pp[s]->X, i4[s])
  for (int s = 0; s < NS; s++) {
    v52_sub_lazy(C.p8, s2[s], pp[s]->Y, r1[s]);
    v52_add_lazy(r1[s], r1[s], rr[s]);
  }
  SQRN(x3, rr[s])
  MULN(t1, pp[s]->Y, j[s])
  for (int s = 0; s < NS; s++) {
    {  // rr == 0 iff rr^2 == 0 (no zero divisors); reduce < 2p then test
      V52 rq = x3[s];
      v52_condsub(C.p4, rq);
      v52_condsub(C.p2, rq);
      r_zero_n[s] = v52_is_zero(C, rq);
    }
    v52_sub_lazy(C.p2, x3[s], j[s], x3[s]);
    v52_add_lazy(v[s], v[s], t0[s]);
    v52_sub_lazy(C.p4, x3[s], t0[s], x3[s]);
    v52_condsub(C.p8, x3[s]);
    v52_sub_lazy(C.p8, v[s], x3[s], t0[s]);
  }
  MULN(y3, rr[s], t0[s])
  MULN(z3, pp[s]->Z, h[s])
  for (int s = 0; s < NS; s++) {
    v52_add_lazy(z3[s], z3[s], z3[s]);  // z3 = 2*Z*h
    v52_add_lazy(t1[s], t1[s], t1[s]);
    v52_sub_lazy(C.p4, y3[s], t1[s], y3[s]);

    __mmask8 p_inf = p_inf_n[s];
    __mmask8 same = valid[s] & h_zero_n[s] & r_zero_n[s] & ~p_inf;
    V52 onev;
    v52_bcast_elem(one52_fq(), onev);
    J52 out;
    out.X = x3[s];
    out.Y = y3[s];
    out.Z = z3[s];
    v52_select(p_inf, px[s], out.X, out.X);
    v52_select(p_inf, py[s], out.Y, out.Y);
    v52_select(p_inf, onev, out.Z, out.Z);
    v52_select(valid[s], out.X, pp[s]->X, pp[s]->X);
    v52_select(valid[s], out.Y, pp[s]->Y, pp[s]->Y);
    v52_select(valid[s], out.Z, pp[s]->Z, pp[s]->Z);
    if (same) {
      for (int lane = 0; lane < 8; lane++) {
        if (!((same >> lane) & 1)) continue;
        G1 g;
        alignas(64) u64 tmp[8];
        u64 t5[5];
        Fp4 ax, ay;
        for (int i = 0; i < 5; i++) {
          _mm512_store_si512((void *)tmp, px[s].l[i]);
          t5[i] = tmp[lane];
        }
        lane_to_mont64(FQ, t5, ax);
        for (int i = 0; i < 5; i++) {
          _mm512_store_si512((void *)tmp, py[s].l[i]);
          t5[i] = tmp[lane];
        }
        lane_to_mont64(FQ, t5, ay);
        g.X = ax;
        g.Y = ay;
        g.Z = FQ.one;
        g.inf = false;
        g1_dbl(g, g);
        j52_set_lane(*pp[s], lane, g);
      }
    }
  }
#undef MULN
#undef SQRN
}

// complete mixed add: p += (px, py) on lanes where `valid`; px/py never
// infinity.  Single-stream convenience wrapper over j52_madd_n.
static void j52_madd(const Ctx52 &C, J52 &p, const V52 &px, const V52 &py,
                     __mmask8 valid) {
  J52 *pp[1] = {&p};
  V52 pxa[1] = {px}, pya[1] = {py};
  __mmask8 va[1] = {valid};
  j52_madd_n<1>(C, pp, pxa, pya, va);
}

// complete Jacobian add: p += q (both may be infinity); equal-point lanes
// fall back to scalar doubling.
static void j52_add(const Ctx52 &C, J52 &p, const J52 &q) {
  V52 z1z1, z2z2, u1, u2, s1, s2, h, r1, rr, i4, j, v, t0, t1, x3, y3, z3;
  V52 a2[2], b2[2], o2[2];
  a2[0] = p.Z;
  a2[1] = q.Z;
  v52_sqr_n<2>(C, a2, o2);  // z1z1 | z2z2
  z1z1 = o2[0];
  z2z2 = o2[1];
  a2[0] = p.X;
  b2[0] = z2z2;
  a2[1] = q.X;
  b2[1] = z1z1;
  v52_mul_n<2>(C, a2, b2, o2);  // u1 | u2
  u1 = o2[0];
  u2 = o2[1];
  a2[0] = p.Y;
  b2[0] = q.Z;
  a2[1] = q.Y;
  b2[1] = p.Z;
  v52_mul_n<2>(C, a2, b2, o2);  // y1*z2 | y2*z1
  a2[0] = o2[0];
  b2[0] = z2z2;
  a2[1] = o2[1];
  b2[1] = z1z1;
  v52_mul_n<2>(C, a2, b2, o2);  // s1 | s2
  s1 = o2[0];
  s2 = o2[1];
  // lazy reduction (see j52_madd_n): interval walk with X/Y/Z < 8p inputs
  // keeps every intermediate below 9.1p < 2^260 with NO conditional
  // subtracts; stored outputs land < 7.5p.  Zero tests move to the squares
  // (h^2, rr^2 — mul outputs < 2p, computed by the formula anyway).
  v52_sub_lazy(C.p2, u2, u1, h);        // h < 3.2p
  v52_sub_lazy(C.p2, s2, s1, r1);       // r1 < 3.04p
  v52_add_lazy(r1, r1, rr);             // rr < 6.1p
  a2[0] = h;
  b2[0] = h;
  a2[1] = p.Z;
  b2[1] = q.Z;
  v52_mul_n<2>(C, a2, b2, o2);  // h^2 | z1*z2
  t0 = o2[0];
  __mmask8 h_zero = v52_is_zero(C, t0);  // h == 0 iff h^2 == 0 (< 1.2p)
  V52 zz = o2[1];
  v52_add_lazy(t0, t0, i4);
  v52_add_lazy(i4, i4, i4);             // i4 < 4.6p
  a2[0] = h;
  b2[0] = i4;
  a2[1] = u1;
  b2[1] = i4;
  v52_mul_n<2>(C, a2, b2, o2);  // j | v
  j = o2[0];
  v = o2[1];
  a2[0] = rr;
  b2[0] = rr;
  a2[1] = s1;
  b2[1] = j;
  v52_mul_n<2>(C, a2, b2, o2);  // rr^2 | s1*j
  x3 = o2[0];
  __mmask8 r_zero = v52_is_zero(C, x3);  // rr == 0 iff rr^2 == 0 (< 1.5p)
  t1 = o2[1];
  v52_sub_lazy(C.p2, x3, j, x3);        // < 3.45p
  v52_add_lazy(v, v, t0);               // 2v < 2.14p
  v52_sub_lazy(C.p4, x3, t0, x3);       // stored X < 7.45p
  v52_sub_lazy(C.p8, v, x3, t0);        // < 9.1p
  v52_add_lazy(zz, zz, zz);             // < 3.6p
  a2[0] = rr;
  b2[0] = t0;
  a2[1] = zz;
  b2[1] = h;
  v52_mul_n<2>(C, a2, b2, o2);  // rr*(v-x3) | 2*z1*z2*h
  t0 = o2[0];
  z3 = o2[1];                           // stored Z < 1.2p
  v52_add_lazy(t1, t1, t1);             // < 2.04p
  v52_sub_lazy(C.p4, t0, t1, y3);       // stored Y < 5.7p

  // infinity tests on the SQUARES (mul outputs, < 2p) — the raw Z inputs may
  // sit anywhere < 8p under the lazy-reduction bucket invariant
  __mmask8 p_inf = v52_is_zero(C, z1z1);
  __mmask8 q_inf = v52_is_zero(C, z2z2);
  __mmask8 same = h_zero & r_zero & ~p_inf & ~q_inf;

  J52 out;
  out.X = x3;
  out.Y = y3;
  out.Z = z3;
  v52_select(p_inf, q.X, out.X, out.X);
  v52_select(p_inf, q.Y, out.Y, out.Y);
  v52_select(p_inf, q.Z, out.Z, out.Z);
  v52_select(q_inf, p.X, out.X, out.X);
  v52_select(q_inf, p.Y, out.Y, out.Y);
  v52_select(q_inf, p.Z, out.Z, out.Z);
  if (same) {
    for (int lane = 0; lane < 8; lane++) {
      if (!((same >> lane) & 1)) continue;
      G1 g;
      j52_get_lane(p, lane, g);
      g1_dbl(g, g);
      j52_set_lane(out, lane, g);
    }
  }
  p = out;
}

// The lane-parallel Pippenger: c = 8 (digit = scalar byte), 8 windows per
// lane group, buckets limb-planar [digit][lane].  ~6-10x the scalar
// window-loop (measured round 5) — used by every commit in the prover.
static const int MSM_PLANES = 15;  // X0..4, Y5..9, Z10..14

// 8x8 u64 transpose: out[j] holds element j of each input row
static inline void transpose8x8(const __m512i r[8], __m512i o[8]) {
  __m512i t[8], s[8];
  for (int k = 0; k < 4; k++) {
    t[2 * k] = _mm512_unpacklo_epi64(r[2 * k], r[2 * k + 1]);
    t[2 * k + 1] = _mm512_unpackhi_epi64(r[2 * k], r[2 * k + 1]);
  }
  s[0] = _mm512_shuffle_i64x2(t[0], t[2], 0x88);
  s[1] = _mm512_shuffle_i64x2(t[1], t[3], 0x88);
  s[2] = _mm512_shuffle_i64x2(t[0], t[2], 0xDD);
  s[3] = _mm512_shuffle_i64x2(t[1], t[3], 0xDD);
  s[4] = _mm512_shuffle_i64x2(t[4], t[6], 0x88);
  s[5] = _mm512_shuffle_i64x2(t[5], t[7], 0x88);
  s[6] = _mm512_shuffle_i64x2(t[4], t[6], 0xDD);
  s[7] = _mm512_shuffle_i64x2(t[5], t[7], 0xDD);
  o[0] = _mm512_shuffle_i64x2(s[0], s[4], 0x88);
  o[1] = _mm512_shuffle_i64x2(s[1], s[5], 0x88);
  o[2] = _mm512_shuffle_i64x2(s[2], s[6], 0x88);
  o[3] = _mm512_shuffle_i64x2(s[3], s[7], 0x88);
  o[4] = _mm512_shuffle_i64x2(s[0], s[4], 0xDD);
  o[5] = _mm512_shuffle_i64x2(s[1], s[5], 0xDD);
  o[6] = _mm512_shuffle_i64x2(s[2], s[6], 0xDD);
  o[7] = _mm512_shuffle_i64x2(s[3], s[7], 0xDD);
}

// Read 8 AoS bucket records (15 u64 each) at byte-lane offsets iv[l]*8 into
// limb-planar J52 form: two unaligned 64B loads per lane (limbs 0..7 and
// 7..14) + two 8x8 transposes.  Replaces 15 vpgatherqq (~285 uops) with 16
// plain loads + 48 shuffles — the shuffle port is idle under the IFMA
// stream, the gather machinery is not.
static inline void j52_load_recs(const long long *bkp, const long long iv[8],
                                 J52 &acc) {
  __m512i r0[8], r1[8], o0[8], o1[8];
  for (int l = 0; l < 8; l++) {
    const long long *base = bkp + iv[l];
    r0[l] = _mm512_loadu_si512((const void *)base);
    r1[l] = _mm512_loadu_si512((const void *)(base + 7));
  }
  transpose8x8(r0, o0);
  transpose8x8(r1, o1);
  for (int i = 0; i < 5; i++) acc.X.l[i] = o0[i];
  acc.Y.l[0] = o0[5];
  acc.Y.l[1] = o0[6];
  acc.Y.l[2] = o0[7];
  acc.Y.l[3] = o1[1];
  acc.Y.l[4] = o1[2];
  for (int i = 0; i < 5; i++) acc.Z.l[i] = o1[3 + i];
}

// Inverse of j52_load_recs for the lanes set in `valid` (two overlapping
// unaligned 64B stores per lane; limb 7 is written twice with one value).
static inline void j52_store_recs(long long *bkp, const long long iv[8],
                                  __mmask8 valid, const J52 &acc) {
  __m512i p0[8], p1[8], r0[8], r1[8];
  for (int i = 0; i < 5; i++) p0[i] = acc.X.l[i];
  p0[5] = acc.Y.l[0];
  p0[6] = acc.Y.l[1];
  p0[7] = acc.Y.l[2];
  p1[0] = acc.Y.l[2];
  p1[1] = acc.Y.l[3];
  p1[2] = acc.Y.l[4];
  for (int i = 0; i < 5; i++) p1[3 + i] = acc.Z.l[i];
  transpose8x8(p0, r0);
  transpose8x8(p1, r1);
  for (int l = 0; l < 8; l++) {
    if (!((valid >> l) & 1)) continue;
    long long *base = bkp + iv[l];
    _mm512_storeu_si512((void *)base, r0[l]);
    _mm512_storeu_si512((void *)(base + 7), r1[l]);
  }
}

// One lane-group of the Pippenger accumulation.  c == 8: digits are scalar
// bytes, group*8 windows per group (4 groups).  c == 12: digits gathered
// with per-lane byte offsets + shifts (22 windows, 3 groups; the top window
// masks to the 2 bits a 254-bit scalar actually has) — fewer window rounds
// for big n at the cost of 2^12-entry buckets.
template <int PEND>
static void msm_ifma_group(const u64 *pxm52, const u64 *pym52,
                           const u64 *scalars, size_t n, int c, int group,
                           G1 wins[8]) {
  const Ctx52 &C = fq52();
  const int B = 1 << c;
  std::vector<u64> bk((size_t)MSM_PLANES * B * 8, 0);  // Z=0 -> all infinity
  const __m512i lane_ids = _mm512_set_epi64(7, 6, 5, 4, 3, 2, 1, 0);
  const int W = (254 + c - 1) / c;
  // c=12 digit-gather tables
  __m512i off_v = _mm512_setzero_si512(), sh_v = off_v, msk_v = off_v;
  if (c != 8) {
    alignas(64) long long offs[8], shs[8], msks[8];
    for (int l = 0; l < 8; l++) {
      int w = group * 8 + l;
      int bit = c * w;
      offs[l] = w < W ? bit >> 3 : 0;
      shs[l] = w < W ? (bit & 7) : 0;
      int remaining = w < W ? (254 - bit < c ? 254 - bit : c) : 0;
      msks[l] = remaining > 0 ? ((1LL << remaining) - 1) : 0;
    }
    off_v = _mm512_load_si512((const void *)offs);
    sh_v = _mm512_load_si512((const void *)shs);
    msk_v = _mm512_load_si512((const void *)msks);
  }
  long long *bkp = (long long *)bk.data();
  // AoS bucket records (15 u64 = X0..4 Y0..4 Z0..4): one record spans 2
  // cache lines vs 15 with planar storage — the difference between L2 and
  // DRAM behavior once B > 2^8.  Records move through j52_load_recs /
  // j52_store_recs (plain loads + transposes, no gather/scatter uops).
  struct Pend {
    __m512i idx15;
    alignas(64) long long iv[8];  // per-lane record offsets (idx*15)
    __mmask8 valid;
    const u64 *px, *py;
  };
  // One-batch-delay software pipeline: entries enqueue into the current
  // batch (issuing bucket-record prefetches when the bucket array spills
  // L2), and the PREVIOUS full batch is processed only once the current one
  // fills — giving each prefetch a full batch (~1.5k cycles) of lead before
  // its gather.  Processing stays FIFO, so conflict semantics are unchanged.
  struct PendBatch {
    Pend p[PEND];
    int n;
  };
  PendBatch batches[2];
  batches[0].n = batches[1].n = 0;
  int cur = 0;
  bool prev_full = false;
  const bool do_prefetch = (size_t)B * 8 * 120 > ((size_t)512 << 10);
  auto prefetch_rec = [&](const long long iv[8], __mmask8 valid) {
    for (int l = 0; l < 8; l++) {
      if (!((valid >> l) & 1)) continue;
      const char *base = (const char *)(bkp + iv[l]);
      _mm_prefetch(base, _MM_HINT_T0);
      _mm_prefetch(base + 64, _MM_HINT_T0);
      _mm_prefetch(base + 119, _MM_HINT_T0);
    }
  };
  auto flush_one = [&](const Pend &P) {
    J52 acc;
    j52_load_recs(bkp, P.iv, acc);
    V52 pxv, pyv;
    for (int i = 0; i < 5; i++) {
      pxv.l[i] = bcast(P.px[i]);
      pyv.l[i] = bcast(P.py[i]);
    }
    j52_madd(C, acc, pxv, pyv, P.valid);
    j52_store_recs(bkp, P.iv, P.valid, acc);
  };
  for (size_t e = 0; e < n; e++) {
    const u64 *sc = scalars + 4 * e;
    if ((sc[0] | sc[1] | sc[2] | sc[3]) == 0) continue;
    const u64 *pxe = pxm52 + 5 * e;
    const u64 *pye = pym52 + 5 * e;
    if ((pxe[0] | pxe[1] | pxe[2] | pxe[3] | pxe[4] | pye[0] | pye[1] |
         pye[2] | pye[3] | pye[4]) == 0)
      continue;  // infinity input
    __m512i dig;
    if (c == 8) {
      u64 dig8;
      memcpy(&dig8, (const uint8_t *)sc + group * 8, 8);
      if (dig8 == 0) continue;
      dig = _mm512_cvtepu8_epi64(_mm_set_epi64x(0, (long long)dig8));
    } else {
      // per-lane u64 loads at byte offsets (scalars padded by the caller so
      // the offset-31 read of the top window never runs past the buffer)
      __m512i raw = _mm512_i64gather_epi64(off_v, (const long long *)sc, 1);
      dig = _mm512_and_si512(_mm512_srlv_epi64(raw, sh_v), msk_v);
    }
    __mmask8 valid =
        _mm512_cmpneq_epu64_mask(dig, _mm512_setzero_si512());
    if (!valid) continue;
    __m512i idx = _mm512_add_epi64(_mm512_slli_epi64(dig, 3), lane_ids);
    if (getenv("H2T_BOUNDS")) {
      alignas(64) u64 iv[8];
      _mm512_store_si512((void *)iv, idx);
      for (int l = 0; l < 8; l++)
        if (iv[l] >= (u64)B * 8) {
          fprintf(stderr, "BAD idx lane %d: %llu (B=%d c=%d group=%d e=%zu)\n",
                  l, (unsigned long long)iv[l], B, c, group, e);
          abort();
        }
    }
    {
      PendBatch &bc = batches[cur];
      Pend &pe = bc.p[bc.n];
      pe.idx15 = _mm512_sub_epi64(_mm512_slli_epi64(idx, 4), idx);
      _mm512_store_si512((void *)pe.iv, pe.idx15);
      pe.valid = valid;
      pe.px = pxe;
      pe.py = pye;
      if (do_prefetch) prefetch_rec(pe.iv, valid);
      if (++bc.n < PEND) continue;
    }
    if (prev_full) {
      Pend *pend = batches[cur ^ 1].p;
      // same-bucket conflict among the pending points -> serialize (rare)
      bool conf = false;
      for (int a = 0; a < PEND && !conf; a++)
        for (int b = a + 1; b < PEND; b++)
          if (pend[a].valid & pend[b].valid &
              _mm512_cmpeq_epu64_mask(pend[a].idx15, pend[b].idx15)) {
            conf = true;
            break;
          }
      if (conf) {
        for (int a = 0; a < PEND; a++) flush_one(pend[a]);
      } else {
        J52 acc[PEND];
        V52 pxN[PEND], pyN[PEND];
        J52 *pp[PEND];
        __mmask8 vv[PEND];
        for (int a = 0; a < PEND; a++) {
          j52_load_recs(bkp, pend[a].iv, acc[a]);
          for (int i = 0; i < 5; i++) {
            pxN[a].l[i] = bcast(pend[a].px[i]);
            pyN[a].l[i] = bcast(pend[a].py[i]);
          }
          pp[a] = &acc[a];
          vv[a] = pend[a].valid;
        }
        j52_madd_n<PEND>(C, pp, pxN, pyN, vv);
        for (int a = 0; a < PEND; a++)
          j52_store_recs(bkp, pend[a].iv, pend[a].valid, acc[a]);
      }
    }
    prev_full = true;
    cur ^= 1;
    batches[cur].n = 0;
  }
  // drain: the delayed full batch first (FIFO), then the partial one
  if (prev_full)
    for (int a = 0; a < PEND; a++) flush_one(batches[cur ^ 1].p[a]);
  for (int a = 0; a < batches[cur].n; a++) flush_one(batches[cur].p[a]);
  // suffix combine: wins = sum_d d * bucket[d], lanes independent
  J52 run, tot;
  memset(&run, 0, sizeof(run));
  memset(&tot, 0, sizeof(tot));
  for (int d = B - 1; d >= 1; d--) {
    J52 b;
    alignas(64) long long ivs[8];
    for (int l = 0; l < 8; l++) ivs[l] = (long long)d * 120 + l * 15;
    j52_load_recs(bkp, ivs, b);
    j52_add(C, run, b);
    j52_add(C, tot, run);
  }
  for (int lane = 0; lane < 8; lane++) j52_get_lane(tot, lane, wins[lane]);
}

// ------------------------------------------------- batch-affine Pippenger
// Buckets live in AFFINE coordinates (10-u64 records + occupancy array) and
// additions run as batched affine adds: one shared inversion per ~256-point
// batch (product tree + a single scalar binary-xgcd inverse) makes the
// per-add cost ~6 vector muls vs ~11 for the Jacobian madd, and bucket
// gathers shrink by a third.  Within a batch every (lane, bucket) target is
// unique (a stamp array defers same-bucket collisions to a later batch —
// bucket sums are order-independent).  The gnark/"batch affine" design,
// rebuilt lane-parallel.  Exceptional lanes (empty bucket, P == ±Q) are
// handled by selects; the true-doubling case falls back to scalar.

static inline __mmask8 v52_eq_exact(const V52 &a, const V52 &b) {
  __mmask8 m = _mm512_cmpeq_epu64_mask(a.l[0], b.l[0]);
  for (int i = 1; i < 5; i++) m &= _mm512_cmpeq_epu64_mask(a.l[i], b.l[i]);
  return m;
}

// canonicalize a value < 4p to exact < p (two conditional subtracts)
static inline void v52_canon4(const Ctx52 &C, V52 &a) {
  v52_condsub(C.p2, a);
  v52_condsub(C.p, a);
}

struct AffBatchRow {
  __m512i idx;       // bucket index per lane (dig*8 + lane)
  __mmask8 accept;   // lanes actually added this batch
  __mmask8 empty;    // accepted lanes whose bucket was unoccupied
  __mmask8 dbl;      // accepted lanes needing a true doubling (scalar path)
  __mmask8 opp;      // accepted lanes where bucket == -point (-> empty)
  const u64 *px, *py;
};

struct AffDeferred {
  const u64 *px, *py;
  alignas(64) u64 dig[8];
};

static void msm_affine_group(const u64 *pxm52, const u64 *pym52,
                             const u64 *scalars, size_t n, int c, int group,
                             G1 wins[8]) {
  const Ctx52 &C = fq52();
  const int B = 1 << c;
  const int W = (254 + c - 1) / c;
  const size_t RB = 256;
  std::vector<u64> bk((size_t)B * 8 * 10, 0);   // affine records x0..4 y0..4
  std::vector<u64> occ((size_t)B * 8, 0);       // 1 = occupied
  std::vector<u64> stamps((size_t)B * 8, 0);    // last batch id that claimed
  u64 batch_id = 0;
  const __m512i lane_ids = _mm512_set_epi64(7, 6, 5, 4, 3, 2, 1, 0);
  // digit extraction tables (same scheme as msm_ifma_group)
  alignas(64) long long offs[8], shs[8], msks[8];
  for (int l = 0; l < 8; l++) {
    int w = group * 8 + l;
    int bit = c * w;
    offs[l] = w < W ? bit >> 3 : 0;
    shs[l] = w < W ? (bit & 7) : 0;
    int remaining = w < W ? (254 - bit < c ? 254 - bit : c) : 0;
    msks[l] = remaining > 0 ? ((1LL << remaining) - 1) : 0;
  }
  const __m512i off_v = _mm512_load_si512((const void *)offs);
  const __m512i sh_v = _mm512_load_si512((const void *)shs);
  const __m512i msk_v = _mm512_load_si512((const void *)msks);

  long long *bkp = (long long *)bk.data();
  long long *occp = (long long *)occ.data();
  long long *stp = (long long *)stamps.data();

  std::vector<V52> bx(RB), by(RB), pxv(RB), pyv(RB), den(RB), num(RB);
  std::vector<AffBatchRow> rows(RB);
  std::vector<V52> tree(2 * RB);  // product tree scratch
  std::vector<AffDeferred> defer, defer_next;

  V52 onev;
  v52_bcast_elem(one52_fq(), onev);
  size_t ndbl = 0, nopp = 0;

  auto add_row = [&](const u64 *pxe, const u64 *pye, __m512i dig,
                     size_t &m) -> void {
    __mmask8 valid = _mm512_cmpneq_epu64_mask(dig, _mm512_setzero_si512());
    if (!valid) return;
    __m512i idx = _mm512_add_epi64(_mm512_slli_epi64(dig, 3), lane_ids);
    __m512i st = _mm512_mask_i64gather_epi64(_mm512_setzero_si512(), valid,
                                             idx, stp, 8);
    __mmask8 conflict =
        valid & _mm512_cmpeq_epu64_mask(st, _mm512_set1_epi64((long long)batch_id));
    __mmask8 accept = valid & ~conflict;
    if (conflict && !getenv("H2T_AFF_NODEFER")) {
      AffDeferred d;
      d.px = pxe;
      d.py = pye;
      _mm512_store_si512((void *)d.dig,
                         _mm512_maskz_mov_epi64(conflict, dig));
      defer_next.push_back(d);
    }
    if (!accept) return;
    _mm512_mask_i64scatter_epi64(stp, accept, idx,
                                 _mm512_set1_epi64((long long)batch_id), 8);
    AffBatchRow &R = rows[m];
    R.idx = idx;
    R.accept = accept;
    R.px = pxe;
    R.py = pye;
    // gather occupancy + bucket coords
    __m512i occv = _mm512_mask_i64gather_epi64(_mm512_setzero_si512(), accept,
                                               idx, occp, 8);
    R.empty = accept & _mm512_cmpeq_epu64_mask(occv, _mm512_setzero_si512());
    __m512i idx10 = _mm512_add_epi64(_mm512_slli_epi64(R.idx, 3),
                                     _mm512_slli_epi64(R.idx, 1));
    for (int i = 0; i < 5; i++) {
      bx[m].l[i] = _mm512_i64gather_epi64(
          _mm512_add_epi64(idx10, _mm512_set1_epi64(i)), bkp, 8);
      by[m].l[i] = _mm512_i64gather_epi64(
          _mm512_add_epi64(idx10, _mm512_set1_epi64(5 + i)), bkp, 8);
      pxv[m].l[i] = bcast(pxe[i]);
      pyv[m].l[i] = bcast(pye[i]);
    }
    __mmask8 samex = R.accept & ~R.empty & v52_eq_exact(bx[m], pxv[m]);
    R.dbl = samex & v52_eq_exact(by[m], pyv[m]);
    R.opp = samex & ~R.dbl;
    ndbl += __builtin_popcount(R.dbl);
    nopp += __builtin_popcount(R.opp);
    // den = px - bx (lazy, < 2p); special lanes -> 1
    V52 d_, nm_;
    __m512i carry;
    for (int i = 0; i < 5; i++) {
      d_.l[i] = _mm512_add_epi64(pxv[m].l[i], bcast(C.p[i]));
      d_.l[i] = _mm512_sub_epi64(d_.l[i], bx[m].l[i]);
      nm_.l[i] = _mm512_add_epi64(pyv[m].l[i], bcast(C.p[i]));
      nm_.l[i] = _mm512_sub_epi64(nm_.l[i], by[m].l[i]);
    }
    // limb-normalize (values < 2p, limbs may be 53-bit)
    const __m512i mask = MASK52;
    carry = _mm512_setzero_si512();
    __m512i carry2 = _mm512_setzero_si512();
    for (int i = 0; i < 5; i++) {
      __m512i s1 = _mm512_add_epi64(d_.l[i], carry);
      carry = _mm512_srai_epi64(s1, 52);
      d_.l[i] = _mm512_and_si512(s1, mask);
      __m512i s2 = _mm512_add_epi64(nm_.l[i], carry2);
      carry2 = _mm512_srai_epi64(s2, 52);
      nm_.l[i] = _mm512_and_si512(s2, mask);
    }
    __mmask8 special = R.empty | R.dbl | R.opp | ~R.accept;
    v52_select(special, onev, d_, den[m]);
    num[m] = nm_;
    m++;
  };

  auto process_batch = [&](size_t m) {
    if (m == 0) return;
    // ---- product tree over den[0..m-1] (pad to pow2 with ones)
    size_t mp = 1;
    while (mp < m) mp <<= 1;
    for (size_t i = 0; i < m; i++) tree[mp + i] = den[i];
    for (size_t i = m; i < mp; i++) tree[mp + i] = onev;
    for (size_t lvl = mp >> 1; lvl >= 1; lvl >>= 1) {
      size_t i = lvl;
      for (; i + 2 <= 2 * lvl; i += 2) {
        V52 a2[2] = {tree[2 * i], tree[2 * (i + 1)]};
        V52 b2[2] = {tree[2 * i + 1], tree[2 * (i + 1) + 1]};
        V52 o2[2];
        v52_mul_n<2>(C, a2, b2, o2);
        tree[i] = o2[0];
        tree[i + 1] = o2[1];
      }
      for (; i < 2 * lvl; i++) v52_mul(C, tree[2 * i], tree[2 * i + 1], tree[i]);
    }
    // ---- scalar root inverse across the 8 lanes
    Fp4 lane64[8], pref[8];
    for (int l = 0; l < 8; l++) {
      alignas(64) u64 tmp[8];
      u64 t5[5];
      for (int i = 0; i < 5; i++) {
        _mm512_store_si512((void *)tmp, tree[1].l[i]);
        t5[i] = tmp[l];
      }
      lane_to_mont64(FQ, t5, lane64[l]);
    }
    Fp4 run = FQ.one;
    for (int l = 0; l < 8; l++) {
      pref[l] = run;
      fp_mul(FQ, run, lane64[l], run);
    }
    Fp4 total_canon, total_inv_canon, total_inv_m;
    fp_from_mont(FQ, run, total_canon);
    fp_inv_canon_vartime(FQ, total_canon, total_inv_canon);
    fp_to_mont(FQ, total_inv_canon, total_inv_m);
    // lane_inv[l] = total_inv * prod_{k>l} lane64[k] * pref[l]
    Fp4 suf = FQ.one;
    V52 rootinv;
    memset(&rootinv, 0, sizeof(rootinv));
    for (int l = 7; l >= 0; l--) {
      Fp4 inv_l, t;
      fp_mul(FQ, total_inv_m, suf, t);
      fp_mul(FQ, t, pref[l], inv_l);
      fp_mul(FQ, suf, lane64[l], suf);
      u64 t5[5];
      mont64_to_lane(FQ, inv_l, t5);
      alignas(64) u64 tmp[8];
      for (int i = 0; i < 5; i++) {
        _mm512_store_si512((void *)tmp, rootinv.l[i]);
        tmp[l] = t5[i];
        rootinv.l[i] = _mm512_load_si512((const void *)tmp);
      }
    }
    // ---- down-sweep: tree[i] holds product; invert downwards
    // reuse tree[] top as inverse storage: inv(1) = rootinv
    std::vector<V52> &inv = tree;  // alias: overwrite as we descend
    V52 root_saved = inv[1];
    inv[1] = rootinv;
    (void)root_saved;
    for (size_t i = 1; i < mp; i++) {
      V52 a2[2], b2[2], o2[2];
      a2[0] = inv[i];
      b2[0] = tree[2 * i + 1];
      a2[1] = inv[i];
      b2[1] = tree[2 * i];
      v52_mul_n<2>(C, a2, b2, o2);  // inv(left) | inv(right)
      inv[2 * i] = o2[0];
      inv[2 * i + 1] = o2[1];
    }
    // ---- per-row affine adds, muls paired across rows (independent chains)
    static thread_local std::vector<V52> lam_v, x3_v;
    lam_v.resize(m);
    x3_v.resize(m);
    {
      size_t r = 0;
      for (; r + 2 <= m; r += 2) {
        V52 a2[2] = {num[r], num[r + 1]};
        V52 b2[2] = {inv[mp + r], inv[mp + r + 1]};
        v52_mul_n<2>(C, a2, b2, &lam_v[r]);
      }
      for (; r < m; r++) v52_mul(C, num[r], inv[mp + r], lam_v[r]);
      r = 0;
      for (; r + 2 <= m; r += 2) {
        V52 a2[2] = {lam_v[r], lam_v[r + 1]};
        v52_mul_n<2>(C, a2, a2, &x3_v[r]);
      }
      for (; r < m; r++) v52_mul(C, lam_v[r], lam_v[r], x3_v[r]);
      // x3 = lam^2 - bx - px; t (stored into num) = bx - x3
      const __m512i mask = MASK52;
      for (r = 0; r < m; r++) {
        __m512i carry = _mm512_setzero_si512();
        V52 &x3 = x3_v[r];
        for (int i = 0; i < 5; i++) {
          __m512i s = _mm512_add_epi64(x3.l[i], bcast(C.p2[i]));
          s = _mm512_sub_epi64(s, _mm512_add_epi64(bx[r].l[i], pxv[r].l[i]));
          s = _mm512_add_epi64(s, carry);
          carry = _mm512_srai_epi64(s, 52);
          x3.l[i] = _mm512_and_si512(s, mask);
        }
        v52_condsub(C.p2, x3);
        v52_condsub(C.p, x3);
        carry = _mm512_setzero_si512();
        for (int i = 0; i < 5; i++) {
          __m512i s = _mm512_add_epi64(bx[r].l[i], bcast(C.p[i]));
          s = _mm512_sub_epi64(s, x3.l[i]);
          s = _mm512_add_epi64(s, carry);
          carry = _mm512_srai_epi64(s, 52);
          num[r].l[i] = _mm512_and_si512(s, mask);
        }
      }
      // y3 = lam*t - by (stored into lam_v)
      r = 0;
      for (; r + 2 <= m; r += 2) {
        V52 a2[2] = {lam_v[r], lam_v[r + 1]};
        V52 b2[2] = {num[r], num[r + 1]};
        v52_mul_n<2>(C, a2, b2, &lam_v[r]);
      }
      for (; r < m; r++) v52_mul(C, lam_v[r], num[r], lam_v[r]);
    }
    for (size_t r = 0; r < m; r += 1) {
      AffBatchRow &R = rows[r];
      V52 x3 = x3_v[r], y3 = lam_v[r];
      const __m512i mask = MASK52;
      __m512i carry = _mm512_setzero_si512();
      for (int i = 0; i < 5; i++) {
        __m512i s = _mm512_add_epi64(y3.l[i], bcast(C.p[i]));
        s = _mm512_sub_epi64(s, by[r].l[i]);
        s = _mm512_add_epi64(s, carry);
        carry = _mm512_srai_epi64(s, 52);
        y3.l[i] = _mm512_and_si512(s, mask);
      }
      v52_condsub(C.p2, y3);
      v52_condsub(C.p, y3);
      // selects: empty -> point; opp handled via occ=0 (coords don't matter)
      v52_select(R.empty, pxv[r], x3, x3);
      v52_select(R.empty, pyv[r], y3, y3);
      __mmask8 wr = R.accept & ~R.dbl;
      __m512i idx10 = _mm512_add_epi64(_mm512_slli_epi64(R.idx, 3),
                                       _mm512_slli_epi64(R.idx, 1));
      for (int i = 0; i < 5; i++) {
        _mm512_mask_i64scatter_epi64(bkp, wr,
                                     _mm512_add_epi64(idx10, _mm512_set1_epi64(i)),
                                     x3.l[i], 8);
        _mm512_mask_i64scatter_epi64(bkp, wr,
                                     _mm512_add_epi64(idx10, _mm512_set1_epi64(5 + i)),
                                     y3.l[i], 8);
      }
      // occupancy: 1 everywhere written except opp -> 0
      _mm512_mask_i64scatter_epi64(occp, wr, R.idx,
                                   _mm512_set1_epi64(1), 8);
      _mm512_mask_i64scatter_epi64(occp, R.opp, R.idx,
                                   _mm512_setzero_si512(), 8);
      if (R.dbl && !getenv("H2T_AFF_NODBL")) {
        // true doubling (rare): scalar affine double of the point
        for (int lane = 0; lane < 8; lane++) {
          if (!((R.dbl >> lane) & 1)) continue;
          alignas(64) u64 tmp[8];
          u64 t5[5];
          Fp4 ax, ay;
          for (int i = 0; i < 5; i++) {
            _mm512_store_si512((void *)tmp, pxv[r].l[i]);
            t5[i] = tmp[lane];
          }
          lane_to_mont64(FQ, t5, ax);
          for (int i = 0; i < 5; i++) {
            _mm512_store_si512((void *)tmp, pyv[r].l[i]);
            t5[i] = tmp[lane];
          }
          lane_to_mont64(FQ, t5, ay);
          G1 g;
          g.X = ax;
          g.Y = ay;
          g.Z = FQ.one;
          g.inf = false;
          g1_dbl(g, g);
          // to affine canonical mont52 record
          Fp4 zi, zi2, zi3, gx, gy;
          fp_inv(FQ, g.Z, zi);
          fp_sqr(FQ, zi, zi2);
          fp_mul(FQ, zi2, zi, zi3);
          fp_mul(FQ, g.X, zi2, gx);
          fp_mul(FQ, g.Y, zi3, gy);
          u64 x5[5], y5[5];
          mont64_to_lane(FQ, gx, x5);
          mont64_to_lane(FQ, gy, y5);
          alignas(64) u64 idxs[8];
          _mm512_store_si512((void *)idxs, R.idx);
          u64 *rec = bk.data() + idxs[lane] * 10;
          for (int i = 0; i < 5; i++) {
            rec[i] = x5[i];
            rec[5 + i] = y5[i];
          }
          occ[idxs[lane]] = 1;
        }
      }
    }
  };

  // ---- main loop: deferred rows first, then fresh points
  size_t nbatches = 0, nrows = 0, ndefer = 0;
  size_t e = 0;
  while (e < n || !defer.empty() || !defer_next.empty()) {
    nbatches++;
    if (defer.empty() && e >= n) {
      defer.swap(defer_next);
    }
    batch_id++;
    size_t m = 0;
    while (m < RB && !defer.empty()) {
      AffDeferred d = defer.back();
      defer.pop_back();
      add_row(d.px, d.py, _mm512_load_si512((const void *)d.dig), m);
    }
    while (m < RB && e < n) {
      const u64 *sc = scalars + 4 * e;
      const u64 *pxe = pxm52 + 5 * e;
      const u64 *pye = pym52 + 5 * e;
      e++;
      if ((sc[0] | sc[1] | sc[2] | sc[3]) == 0) continue;
      if ((pxe[0] | pxe[1] | pxe[2] | pxe[3] | pxe[4] | pye[0] | pye[1] |
           pye[2] | pye[3] | pye[4]) == 0)
        continue;
      __m512i raw = _mm512_i64gather_epi64(off_v, (const long long *)sc, 1);
      __m512i dig = _mm512_and_si512(_mm512_srlv_epi64(raw, sh_v), msk_v);
      add_row(pxe, pye, dig, m);
    }
    nrows += m;
    ndefer += defer_next.size();
    process_batch(m);
    if (defer.empty()) defer.swap(defer_next);
  }
  if (getenv("H2T_MSM_DEBUG"))
    fprintf(stderr, "[affine g%d] batches=%zu rows=%zu defer=%zu dbl=%zu opp=%zu\n",
            group, nbatches, nrows, ndefer, ndbl, nopp);

  // ---- suffix combine over affine buckets (Jacobian run/tot, mixed adds)
  J52 run, tot;
  memset(&run, 0, sizeof(run));
  memset(&tot, 0, sizeof(tot));
  __m512i lane10 = _mm512_add_epi64(_mm512_slli_epi64(lane_ids, 3),
                                    _mm512_slli_epi64(lane_ids, 1));
  for (int d = B - 1; d >= 1; d--) {
    V52 bxd, byd;
    __m512i base_d = _mm512_add_epi64(lane10, _mm512_set1_epi64((long long)d * 80));
    for (int i = 0; i < 5; i++) {
      bxd.l[i] = _mm512_i64gather_epi64(_mm512_add_epi64(base_d, _mm512_set1_epi64(i)), bkp, 8);
      byd.l[i] = _mm512_i64gather_epi64(_mm512_add_epi64(base_d, _mm512_set1_epi64(5 + i)), bkp, 8);
    }
    __m512i occv = _mm512_i64gather_epi64(
        _mm512_add_epi64(_mm512_set1_epi64((long long)d * 8), lane_ids), occp, 8);
    __mmask8 valid = _mm512_cmpneq_epu64_mask(occv, _mm512_setzero_si512());
    if (valid) j52_madd(C, run, bxd, byd, valid);
    j52_add(C, tot, run);
  }
  for (int lane = 0; lane < 8; lane++) j52_get_lane(tot, lane, wins[lane]);
}

// full IFMA MSM: points in 4x64 Montgomery affine ((0,0) = infinity)
static void msm_ifma(const Fp4 *px_m, const Fp4 *py_m, const u64 *scalars,
                     size_t n, G1 &result, const u64 *pxm52_pre = nullptr,
                     const u64 *pym52_pre = nullptr, bool use_threads = true) {
  std::vector<u64> px52s, py52s;
  const u64 *pxm52 = pxm52_pre, *pym52 = pym52_pre;
  if (!pxm52) {
    px52s.resize(5 * n);
    py52s.resize(5 * n);
    for (size_t e = 0; e < n; e++) {
      if (fp_is_zero(px_m[e]) && fp_is_zero(py_m[e])) {
        memset(&px52s[5 * e], 0, 40);
        memset(&py52s[5 * e], 0, 40);
      } else {
        mont64_to_lane(FQ, px_m[e], &px52s[5 * e]);
        mont64_to_lane(FQ, py_m[e], &py52s[5 * e]);
      }
    }
    pxm52 = px52s.data();
    pym52 = py52s.data();
  }
  // Window width: byte digits (4 lane groups, 256-entry buckets) while the
  // suffix combine would dominate; 11-bit digits (24 windows = 3 full lane
  // groups, 2^11-entry buckets ~ 1.9 MB/group) once n amortizes the longer
  // suffix — measured fastest at BOTH 2^16 and 2^20 on this box (the 25%
  // fewer bucket passes beat the L2->L3 gather spill once the lazy madd
  // shortened the compute chains).  Crossover n ~ 2^15 by op count.
  int c = n < ((size_t)1 << 15) ? 8 : 11;
  if (const char *cenv = getenv("H2T_MSM_C")) c = atoi(cenv);
  const int W = (254 + c - 1) / c;
  const int ngroups = (W + 7) / 8;
  const u64 *sc_use = scalars;
  std::vector<u64> sc_pad;
  if (c != 8) {
    // top-window loads read 8 bytes at offset 31 of the last element — pad
    sc_pad.assign(scalars, scalars + 4 * n);
    sc_pad.resize(4 * n + 4, 0);
    sc_use = sc_pad.data();
  }
  G1 wins[32];
  for (auto &w : wins) w.inf = true;
  // 2 interleaved madd streams measured best once the lazy-reduction madd
  // shortened the serial carry chains (3 streams spill past the 32-zmm file)
  int pend_depth = 2;
  if (const char *pe = getenv("H2T_MSM_PEND")) pend_depth = atoi(pe);
  auto run_group = [&](int g, const u64 *px, const u64 *py, const u64 *sc,
                       size_t cnt, G1 *w8) {
    // The batch-affine path measured SLOWER than the interleaved Jacobian
    // madd on this 2-core part (gathers + per-row batch machinery outweigh
    // the 11->6 mul saving); it stays available for wider parts via
    // H2T_MSM_AFFINE=1.  The LAST group always runs Jacobian: its narrow
    // top window (1-2 bit digit space) would collapse the batch-affine
    // deferral into a quadratic retry storm.
    if (c == 8 || g == ngroups - 1 || !getenv("H2T_MSM_AFFINE")) {
      switch (pend_depth) {
        case 2: msm_ifma_group<2>(px, py, sc, cnt, c, g, w8); break;
        case 4: msm_ifma_group<4>(px, py, sc, cnt, c, g, w8); break;
        default: msm_ifma_group<3>(px, py, sc, cnt, c, g, w8); break;
      }
    } else {
      msm_affine_group(px, py, sc, cnt, c, g, w8);
    }
  };
  int nt = use_threads ? num_threads() : 1;
  if (n < 2048) nt = 1;
  if (nt <= 1) {
    for (int g = 0; g < ngroups; g++)
      run_group(g, pxm52, pym52, sc_use, n, wins + 8 * g);
  } else {
    // Point-split: each thread runs ALL window groups over its own point
    // slice into private window sums; per-thread sums merge by MSM
    // linearity with 32*(nt-1) scalar Jacobian adds.  Unlike the previous
    // group-per-thread split this balances perfectly for any (ngroups, nt)
    // — wall time is ngroups*n/nt point-adds instead of
    // ceil(ngroups/nt)*n (25% fewer at c=12 on 2 cores).
    std::vector<G1> tw((size_t)nt * 32);
    for (auto &w : tw) w.inf = true;
    std::vector<std::thread> threads;
    size_t step = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      size_t lo = std::min(n, (size_t)t * step), hi = std::min(n, lo + step);
      if (lo >= hi) continue;
      threads.emplace_back([&, t, lo, hi]() {
        for (int g = 0; g < ngroups; g++)
          run_group(g, pxm52 + 5 * lo, pym52 + 5 * lo, sc_use + 4 * lo,
                    hi - lo, tw.data() + 32 * t + 8 * g);
      });
    }
    for (auto &th : threads) th.join();
    for (int t = 0; t < nt; t++)
      for (int w = 0; w < 32; w++)
        if (!tw[(size_t)32 * t + w].inf)
          g1_add(wins[w], wins[w], tw[(size_t)32 * t + w]);
  }
  // Horner over the W c-bit windows
  G1 acc;
  acc.inf = true;
  for (int w = W - 1; w >= 0; w--) {
    for (int b = 0; b < c; b++) g1_dbl(acc, acc);
    g1_add(acc, acc, wins[w]);
  }
  result = acc;
}

// Transpose 8 columns of (n, 4)-u64 canonical elements into a planar
// Montgomery-52 block (and back).  cols[e] may be null (padding lanes).
static void block_load(const Fp4 *const cols[8], size_t n, V52 *buf) {
  const Ctx52 &C = fr52();
  Fp4 tmp[8];
  for (size_t i = 0; i < n; i++) {
    for (int e = 0; e < 8; e++)
      tmp[e] = cols[e] ? cols[e][i] : Fp4{{0, 0, 0, 0}};
    v52_load_mont(C, tmp, buf[i]);
  }
}

static void block_store(Fp4 *const cols[8], size_t n, const V52 *buf) {
  const Ctx52 &C = fr52();
  Fp4 tmp[8];
  for (size_t i = 0; i < n; i++) {
    v52_store_canon(C, buf[i], tmp);
    for (int e = 0; e < 8; e++)
      if (cols[e]) cols[e][i] = tmp[e];
  }
}

}  // namespace

#endif  // H2T_IFMA

}  // namespace

// ====================================================================== ABI
extern "C" {

void h2t_set_threads(int n) { g_num_threads = n; }

// field: 0 = Fr, 1 = Fq.  In-place canonical <-> Montgomery conversions.
void h2t_to_mont(int field, u64 *a, size_t n) {
  const FieldCtx &F = ctx_of(field);
  Fp4 *v = (Fp4 *)a;
  for (size_t i = 0; i < n; i++) fp_to_mont(F, v[i], v[i]);
}

void h2t_from_mont(int field, u64 *a, size_t n) {
  const FieldCtx &F = ctx_of(field);
  Fp4 *v = (Fp4 *)a;
  for (size_t i = 0; i < n; i++) fp_from_mont(F, v[i], v[i]);
}

// elementwise c[i] = a[i] * b[i] (canonical in/out)
void h2t_mul(int field, const u64 *a, const u64 *b, u64 *c, size_t n) {
  const FieldCtx &F = ctx_of(field);
  const Fp4 *va = (const Fp4 *)a, *vb = (const Fp4 *)b;
  Fp4 *vc = (Fp4 *)c;
  size_t i = 0;
#ifdef H2T_IFMA
  if (field == 0) {
    const Ctx52 &C = fr52();
    for (; i + 16 <= n; i += 16) {
      V52 x[2], y[2];
      v52_load_mont2(C, va + i, va + i + 8, x[0], x[1]);
      v52_load_mont2(C, vb + i, vb + i + 8, y[0], y[1]);
      v52_mul_n<2>(C, x, y, x);
      v52_store_canon2(C, x[0], x[1], vc + i, vc + i + 8);
    }
    for (; i + 8 <= n; i += 8) {
      V52 x, y;
      v52_load_mont(C, va + i, x);
      v52_load_mont(C, vb + i, y);
      v52_mul(C, x, y, x);
      v52_store_canon(C, x, vc + i);
    }
  }
#endif
  for (; i < n; i++) {
    Fp4 am, bm;
    fp_to_mont(F, va[i], am);
    fp_to_mont(F, vb[i], bm);
    fp_mul(F, am, bm, vc[i]);
    fp_from_mont(F, vc[i], vc[i]);
  }
}

// MSM over BN254 G1.  px/py: n affine coords, CANONICAL, (0,0) = infinity;
// scalars canonical Fr.  out: 8 u64 = affine (x, y) canonical, (0,0) = inf.
// Returns 0 on success.
int h2t_msm_g1(const u64 *px, const u64 *py, const u64 *scalars, size_t n,
               u64 *out) {
  std::vector<Fp4> pxm(n), pym(n);
  const Fp4 *vx = (const Fp4 *)px, *vy = (const Fp4 *)py;
  for (size_t i = 0; i < n; i++) {
    if (fp_is_zero(vx[i]) && fp_is_zero(vy[i])) {
      memset(pxm[i].l, 0, 32);
      memset(pym[i].l, 0, 32);
    } else {
      fp_to_mont(FQ, vx[i], pxm[i]);
      fp_to_mont(FQ, vy[i], pym[i]);
    }
  }
  G1 r;
  msm_impl(pxm.data(), pym.data(), scalars, n, r);
  Fp4 ox = {{0, 0, 0, 0}}, oy = {{0, 0, 0, 0}};
  if (!r.inf && !fp_is_zero(r.Z)) {
    Fp4 zi, zi2, zi3;
    fp_inv(FQ, r.Z, zi);
    fp_sqr(FQ, zi, zi2);
    fp_mul(FQ, zi2, zi, zi3);
    fp_mul(FQ, r.X, zi2, ox);
    fp_mul(FQ, r.Y, zi3, oy);
    fp_from_mont(FQ, ox, ox);
    fp_from_mont(FQ, oy, oy);
  }
  memcpy(out, ox.l, 32);
  memcpy(out + 4, oy.l, 32);
  return 0;
}

// Same MSM but px/py given in MONTGOMERY form (skips the conversion — the
// Python side holds SRS coordinates Montgomery-encoded already).
int h2t_msm_g1_mont(const u64 *px_m, const u64 *py_m, const u64 *scalars,
                    size_t n, u64 *out) {
  G1 r;
#ifdef H2T_IFMA
  msm_ifma((const Fp4 *)px_m, (const Fp4 *)py_m, scalars, n, r);
#else
  msm_impl((const Fp4 *)px_m, (const Fp4 *)py_m, scalars, n, r);
#endif
  Fp4 ox = {{0, 0, 0, 0}}, oy = {{0, 0, 0, 0}};
  if (!r.inf && !fp_is_zero(r.Z)) {
    Fp4 zi, zi2, zi3;
    fp_inv(FQ, r.Z, zi);
    fp_sqr(FQ, zi, zi2);
    fp_mul(FQ, zi2, zi, zi3);
    fp_mul(FQ, r.X, zi2, ox);
    fp_mul(FQ, r.Y, zi3, oy);
    fp_from_mont(FQ, ox, ox);
    fp_from_mont(FQ, oy, oy);
  }
  memcpy(out, ox.l, 32);
  memcpy(out + 4, oy.l, 32);
  return 0;
}

// Precompute the Montgomery-52 lane form of a fixed point set (the SRS is
// fixed across every commit of a proof — converting per MSM call wastes a
// full pass over n).  px52/py52: (n, 5) u64, all-zero rows = infinity.
// Returns 0, or -1 when built without IFMA (caller falls back).
int h2t_points_to52(const u64 *px_m, const u64 *py_m, size_t n, u64 *px52,
                    u64 *py52) {
#ifdef H2T_IFMA
  const Fp4 *vx = (const Fp4 *)px_m, *vy = (const Fp4 *)py_m;
  auto work = [&](size_t lo, size_t hi) {
    for (size_t e = lo; e < hi; e++) {
      if (fp_is_zero(vx[e]) && fp_is_zero(vy[e])) {
        memset(px52 + 5 * e, 0, 40);
        memset(py52 + 5 * e, 0, 40);
      } else {
        mont64_to_lane(FQ, vx[e], px52 + 5 * e);
        mont64_to_lane(FQ, vy[e], py52 + 5 * e);
      }
    }
  };
  int nt = num_threads();
  if (nt <= 1 || n < 4096) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    size_t step = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      size_t lo = std::min(n, (size_t)t * step), hi = std::min(n, lo + step);
      if (lo < hi) threads.emplace_back(work, lo, hi);
    }
    for (auto &th : threads) th.join();
  }
  return 0;
#else
  (void)px_m;
  (void)py_m;
  (void)n;
  (void)px52;
  (void)py52;
  return -1;
#endif
}

// MSM over precomputed 52-lane points (see h2t_points_to52); scalars and
// output as in h2t_msm_g1_mont.  Returns -1 without IFMA.
int h2t_msm_g1_mont52(const u64 *px52, const u64 *py52, const u64 *scalars,
                      size_t n, u64 *out) {
#ifdef H2T_IFMA
  G1 r;
  msm_ifma(nullptr, nullptr, scalars, n, r, px52, py52);
  Fp4 ox = {{0, 0, 0, 0}}, oy = {{0, 0, 0, 0}};
  if (!r.inf && !fp_is_zero(r.Z)) {
    Fp4 zi, zi2, zi3;
    fp_inv(FQ, r.Z, zi);
    fp_sqr(FQ, zi, zi2);
    fp_mul(FQ, zi2, zi, zi3);
    fp_mul(FQ, r.X, zi2, ox);
    fp_mul(FQ, r.Y, zi3, oy);
    fp_from_mont(FQ, ox, ox);
    fp_from_mont(FQ, oy, oy);
  }
  memcpy(out, ox.l, 32);
  memcpy(out + 4, oy.l, 32);
  return 0;
#else
  (void)px52;
  (void)py52;
  (void)scalars;
  (void)n;
  (void)out;
  return -1;
#endif
}

// Batched MSM: nb scalar vectors over the SAME points (the per-phase commit
// shape: many polys, one SRS).  scalars: nb * n elements; out: nb * 8 u64.
int h2t_msm_g1_mont_batch(const u64 *px_m, const u64 *py_m, const u64 *scalars,
                          size_t n, size_t nb, u64 *out) {
#ifdef H2T_IFMA
  {
    // convert the shared points to Montgomery-52 ONCE, then thread over the
    // batch (each per-b MSM runs its lane groups single-threaded)
    std::vector<u64> px52(5 * n), py52(5 * n);
    const Fp4 *vx = (const Fp4 *)px_m, *vy = (const Fp4 *)py_m;
    for (size_t e = 0; e < n; e++) {
      if (fp_is_zero(vx[e]) && fp_is_zero(vy[e])) {
        memset(&px52[5 * e], 0, 40);
        memset(&py52[5 * e], 0, 40);
      } else {
        mont64_to_lane(FQ, vx[e], &px52[5 * e]);
        mont64_to_lane(FQ, vy[e], &py52[5 * e]);
      }
    }
    auto finish = [&](const G1 &r, u64 *o) {
      Fp4 ox = {{0, 0, 0, 0}}, oy = {{0, 0, 0, 0}};
      if (!r.inf && !fp_is_zero(r.Z)) {
        Fp4 zi, zi2, zi3;
        fp_inv(FQ, r.Z, zi);
        fp_sqr(FQ, zi, zi2);
        fp_mul(FQ, zi2, zi, zi3);
        fp_mul(FQ, r.X, zi2, ox);
        fp_mul(FQ, r.Y, zi3, oy);
        fp_from_mont(FQ, ox, ox);
        fp_from_mont(FQ, oy, oy);
      }
      memcpy(o, ox.l, 32);
      memcpy(o + 4, oy.l, 32);
    };
    auto run = [&](size_t b, bool threaded_groups) {
      G1 r;
      msm_ifma(vx, vy, scalars + 4 * n * b, n, r, px52.data(), py52.data(),
               threaded_groups);
      finish(r, out + 8 * b);
    };
    int nt = num_threads();
    if ((size_t)nt > nb) nt = (int)nb;
    if (nt <= 1) {
      for (size_t b = 0; b < nb; b++) run(b, nb == 1);
    } else {
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; t++)
        threads.emplace_back([&, t]() {
          for (size_t b = t; b < nb; b += (size_t)nt) run(b, false);
        });
      for (auto &th : threads) th.join();
    }
    return 0;
  }
#endif
  int nt = num_threads();
  if ((size_t)nt > nb) nt = (int)nb;
  auto run = [&](size_t b) {
    h2t_msm_g1_mont(px_m, py_m, scalars + 4 * n * b, n, out + 8 * b);
  };
  if (nt <= 1) {
    for (size_t b = 0; b < nb; b++) run(b);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++)
      threads.emplace_back([&, t]() {
        for (size_t b = t; b < nb; b += nt) run(b);
      });
    for (auto &th : threads) th.join();
  }
  return 0;
}

// In-place radix-2 NTT over Fr, canonical in/out, natural order both ways;
// matches poly/domain.py's _ntt_fn butterfly schedule bit-exactly.
void h2t_ntt_fr(u64 *a, size_t n, int inverse) {
  Fp4 *v = (Fp4 *)a;
  for (size_t i = 0; i < n; i++) fp_to_mont(FR, v[i], v[i]);
  ntt_mont(v, n, inverse != 0);
  for (size_t i = 0; i < n; i++) fp_from_mont(FR, v[i], v[i]);
}

// Batched NTT: nb independent length-n transforms.  IFMA path: 8 columns
// per lane-block, threads over blocks; scalar fallback threads over columns.
void h2t_ntt_fr_batch(u64 *a, size_t nb, size_t n, int inverse) {
#ifdef H2T_IFMA
  {
    size_t nblocks = (nb + 7) / 8;
    auto run_block = [&](size_t blk) {
      const Fp4 *ci[8];
      Fp4 *co[8];
      for (int e = 0; e < 8; e++) {
        size_t col = blk * 8 + e;
        ci[e] = col < nb ? (const Fp4 *)(a + 4 * n * col) : nullptr;
        co[e] = col < nb ? (Fp4 *)(a + 4 * n * col) : nullptr;
      }
      std::vector<V52> buf(n);
      block_load(ci, n, buf.data());
      ntt_ifma_block(buf.data(), n, inverse != 0);
      block_store(co, n, buf.data());
    };
    twiddle_table(n, inverse != 0);  // build once before threads fan out
    int nt = num_threads();
    if ((size_t)nt > nblocks) nt = (int)nblocks;
    if (nt <= 1) {
      for (size_t blk = 0; blk < nblocks; blk++) run_block(blk);
    } else {
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; t++)
        threads.emplace_back([&, t]() {
          for (size_t blk = t; blk < nblocks; blk += (size_t)nt) run_block(blk);
        });
      for (auto &th : threads) th.join();
    }
    return;
  }
#endif
  int nt = num_threads();
  if ((size_t)nt > nb) nt = (int)nb;
  if (nt <= 1) {
    for (size_t b = 0; b < nb; b++) h2t_ntt_fr(a + 4 * n * b, n, inverse);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++)
    threads.emplace_back([=]() {
      for (size_t b = t; b < nb; b += nt) h2t_ntt_fr(a + 4 * n * b, n, inverse);
    });
  for (auto &th : threads) th.join();
}

// Fused pad + coset-scale + forward-NTT for nb columns (the dominant slice
// of the native quotient phase: one pass per 8-column block, twiddles and
// the scale row shared).  in: nb*(n_in,4); out: nb*(ext_n,4); coset_row:
// (ext_n,4) canonical scale factors (g^i powers).
void h2t_coset_ntt_fr_batch(const u64 *in, size_t nb, size_t n_in, u64 *out,
                            size_t ext_n, const u64 *coset_row) {
#ifdef H2T_IFMA
  {
    const Ctx52 &C = fr52();
    // scale row -> Montgomery-52 scalars, shared across blocks/threads
    std::vector<u64> row52(5 * ext_n);
    const Fp4 *rowv = (const Fp4 *)coset_row;
    for (size_t i = 0; i < ext_n; i++)
      scalar_to_mont52(C, rowv[i], &row52[5 * i]);
    twiddle_table(ext_n, false);
    size_t nblocks = (nb + 7) / 8;
    auto run_block = [&](size_t blk) {
      const Fp4 *ci[8];
      Fp4 *co[8];
      for (int e = 0; e < 8; e++) {
        size_t col = blk * 8 + e;
        ci[e] = col < nb ? (const Fp4 *)(in + 4 * n_in * col) : nullptr;
        co[e] = col < nb ? (Fp4 *)(out + 4 * ext_n * col) : nullptr;
      }
      std::vector<V52> buf(ext_n);
      block_load(ci, n_in, buf.data());  // low n_in entries
      memset(buf.data() + n_in, 0, (ext_n - n_in) * sizeof(V52));
      for (size_t i = 0; i < n_in; i++) {  // zero rows stay zero
        V52 s;
        v52_bcast_elem(&row52[5 * i], s);
        v52_mul(C, buf[i], s, buf[i]);
      }
      ntt_ifma_block(buf.data(), ext_n, false);
      block_store(co, ext_n, buf.data());
    };
    int nt = num_threads();
    if ((size_t)nt > nblocks) nt = (int)nblocks;
    if (nt <= 1) {
      for (size_t blk = 0; blk < nblocks; blk++) run_block(blk);
    } else {
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; t++)
        threads.emplace_back([&, t]() {
          for (size_t blk = t; blk < nblocks; blk += (size_t)nt) run_block(blk);
        });
      for (auto &th : threads) th.join();
    }
    return;
  }
#endif
  // scalar fallback: pad + scale + per-column NTT
  for (size_t b = 0; b < nb; b++) {
    u64 *dst = out + 4 * ext_n * b;
    memcpy(dst, in + 4 * n_in * b, 32 * n_in);
    memset(dst + 4 * n_in, 0, 32 * (ext_n - n_in));
    Fp4 *v = (Fp4 *)dst;
    const Fp4 *rowv = (const Fp4 *)coset_row;
    for (size_t i = 0; i < n_in; i++) {
      Fp4 am, rm;
      fp_to_mont(FR, v[i], am);
      fp_to_mont(FR, rowv[i], rm);
      fp_mul(FR, am, rm, v[i]);
      fp_from_mont(FR, v[i], v[i]);
    }
  }
  h2t_ntt_fr_batch(out, nb, ext_n, 0);
}

// Batched elementwise multiply by a SHARED row: a[b][i] *= s[i] (canonical).
// The coset scale of coeff_to_extended across many columns at once.
void h2t_scale_row_fr_batch(u64 *a, size_t nb, size_t n, const u64 *s) {
  std::vector<Fp4> sm(n);
  const Fp4 *vs = (const Fp4 *)s;
  for (size_t i = 0; i < n; i++) fp_to_mont(FR, vs[i], sm[i]);
  int nt = num_threads();
  if ((size_t)nt > nb) nt = (int)nb;
  auto run = [&](size_t b) {
    Fp4 *v = (Fp4 *)(a + 4 * n * b);
    size_t i = 0;
#ifdef H2T_IFMA
    {
      const Ctx52 &C = fr52();
      for (; i + 8 <= n; i += 8) {
        V52 x, y;
        v52_load_mont(C, v + i, x);
        v52_load_mont(C, (const Fp4 *)vs + i, y);
        v52_mul(C, x, y, x);
        v52_store_canon(C, x, v + i);
      }
    }
#endif
    for (; i < n; i++) {
      Fp4 am;
      fp_to_mont(FR, v[i], am);
      fp_mul(FR, am, sm[i], v[i]);
      fp_from_mont(FR, v[i], v[i]);
    }
  };
  if (nt <= 1) {
    for (size_t b = 0; b < nb; b++) run(b);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++)
    threads.emplace_back([&, t]() {
      for (size_t b = t; b < nb; b += nt) run(b);
    });
  for (auto &th : threads) th.join();
}

// a[i] *= g^i (canonical).  The coset scale of coeff_to_extended.
void h2t_scale_powers_fr(u64 *a, size_t n, const u64 *g) {
  Fp4 gm, acc = FR.one;
  fp_to_mont(FR, *(const Fp4 *)g, gm);
  Fp4 *v = (Fp4 *)a;
  for (size_t i = 0; i < n; i++) {
    Fp4 am;
    fp_to_mont(FR, v[i], am);
    fp_mul(FR, am, acc, v[i]);
    fp_from_mont(FR, v[i], v[i]);
    fp_mul(FR, acc, gm, acc);
  }
}

// In-place batched inversion over Fr (canonical); inv(0) = 0.
void h2t_batch_inv_fr(u64 *a, size_t n) {
  Fp4 *v = (Fp4 *)a;
  std::vector<Fp4> pref(n);
  Fp4 run = FR.one;
  std::vector<Fp4> vm(n);
  for (size_t i = 0; i < n; i++) {
    fp_to_mont(FR, v[i], vm[i]);
    pref[i] = run;
    if (!fp_is_zero(vm[i])) fp_mul(FR, run, vm[i], run);
  }
  Fp4 inv;
  fp_inv(FR, run, inv);
  for (size_t i = n; i-- > 0;) {
    if (fp_is_zero(vm[i])) {
      memset(v[i].l, 0, 32);
      continue;
    }
    Fp4 r;
    fp_mul(FR, inv, pref[i], r);
    fp_mul(FR, inv, vm[i], inv);
    fp_from_mont(FR, r, v[i]);
  }
}

// Grand-product recurrence: z[0] = carry_in, z[r+1] = z[r]*num[r]/den[r],
// r = 0..u-1.  num/den/carry canonical; writes u+1 canonical elements.
void h2t_grand_product_fr(const u64 *num, const u64 *den, size_t u,
                          const u64 *carry_in, u64 *z_out) {
  std::vector<Fp4> dinv(u);
  memcpy(dinv.data(), den, 32 * u);
  h2t_batch_inv_fr((u64 *)dinv.data(), u);
  const Fp4 *vn = (const Fp4 *)num;
  Fp4 *vz = (Fp4 *)z_out;
  Fp4 z;
  fp_to_mont(FR, *(const Fp4 *)carry_in, z);
  fp_from_mont(FR, z, vz[0]);
  for (size_t r = 0; r < u; r++) {
    Fp4 nm, dm;
    fp_to_mont(FR, vn[r], nm);
    fp_to_mont(FR, dinv[r], dm);
    fp_mul(FR, z, nm, z);
    fp_mul(FR, z, dm, z);
    fp_from_mont(FR, z, vz[r + 1]);
  }
}

// Expression-VM evaluation over Fr (the quotient-phase instruction program,
// plonkish/evaluator.Program): base holds nbase row-vectors of n canonical
// values (queries pre-rotated by the caller, then constants); instrs is
// (ni, 4) int32 [op, src1, src2, dst] with ops 0=add, 1=mul, 2=neg and slot
// indices into the concatenated [base | instruction-results] buffer.
// out receives nout rows gathered from out_slots.  Threads split the row
// axis; every instruction is elementwise so chunks never communicate.
#ifdef H2T_IFMA
// IFMA chunk: slots live as planar Montgomery-52 vectors, 8 row elements
// per lane; requires (hi - lo) % 8 == 0 (the caller aligns chunks).
static void expr_eval_chunk_ifma(const u64 *base, size_t nbase, size_t n,
                                 size_t lo, size_t hi, const int32_t *instrs,
                                 size_t ni, const int32_t *out_slots,
                                 size_t nout, u64 *out) {
  const Ctx52 &C = fr52();
  const size_t w = hi - lo;
  const size_t wv = w / 8;
  std::vector<V52> buf((nbase + ni) * wv);
  const Fp4 *vb = (const Fp4 *)base;
  for (size_t b = 0; b < nbase; b++) {
    size_t j = 0;
    for (; j + 2 <= wv; j += 2)
      v52_load_mont2(C, vb + b * n + lo + 8 * j, vb + b * n + lo + 8 * (j + 1),
                     buf[b * wv + j], buf[b * wv + j + 1]);
    for (; j < wv; j++)
      v52_load_mont(C, vb + b * n + lo + 8 * j, buf[b * wv + j]);
  }
  for (size_t i = 0; i < ni; i++) {
    const int32_t op = instrs[4 * i], s1 = instrs[4 * i + 1],
                  s2 = instrs[4 * i + 2], dst = instrs[4 * i + 3];
    const V52 *a = &buf[(size_t)s1 * wv];
    const V52 *b = &buf[(size_t)s2 * wv];
    V52 *d = &buf[(size_t)dst * wv];
    if (op == 0)
      for (size_t j = 0; j < wv; j++) v52_add(C, a[j], b[j], d[j]);
    else if (op == 1) {
      size_t j = 0;
      for (; j + 2 <= wv; j += 2) v52_mul_n<2>(C, a + j, b + j, d + j);
      for (; j < wv; j++) v52_mul(C, a[j], b[j], d[j]);
    } else
      for (size_t j = 0; j < wv; j++) v52_neg(C, a[j], d[j]);
  }
  Fp4 *vo = (Fp4 *)out;
  for (size_t o = 0; o < nout; o++) {
    size_t j = 0;
    for (; j + 2 <= wv; j += 2)
      v52_store_canon2(C, buf[(size_t)out_slots[o] * wv + j],
                       buf[(size_t)out_slots[o] * wv + j + 1],
                       vo + o * n + lo + 8 * j, vo + o * n + lo + 8 * (j + 1));
    for (; j < wv; j++)
      v52_store_canon(C, buf[(size_t)out_slots[o] * wv + j],
                      vo + o * n + lo + 8 * j);
  }
}
#endif

static void expr_eval_chunk(const u64 *base, size_t nbase, size_t n, size_t lo,
                            size_t hi, const int32_t *instrs, size_t ni,
                            const int32_t *out_slots, size_t nout, u64 *out) {
#ifdef H2T_IFMA
  if ((hi - lo) % 8 == 0) {
    expr_eval_chunk_ifma(base, nbase, n, lo, hi, instrs, ni, out_slots, nout,
                         out);
    return;
  }
#endif
  const size_t w = hi - lo;
  std::vector<Fp4> buf((nbase + ni) * w);
  const Fp4 *vb = (const Fp4 *)base;
  for (size_t b = 0; b < nbase; b++)
    for (size_t j = 0; j < w; j++)
      fp_to_mont(FR, vb[b * n + lo + j], buf[b * w + j]);
  for (size_t i = 0; i < ni; i++) {
    const int32_t op = instrs[4 * i], s1 = instrs[4 * i + 1],
                  s2 = instrs[4 * i + 2], dst = instrs[4 * i + 3];
    const Fp4 *a = &buf[(size_t)s1 * w];
    const Fp4 *b = &buf[(size_t)s2 * w];
    Fp4 *d = &buf[(size_t)dst * w];
    if (op == 0)
      for (size_t j = 0; j < w; j++) fp_add(FR, a[j], b[j], d[j]);
    else if (op == 1)
      for (size_t j = 0; j < w; j++) fp_mul(FR, a[j], b[j], d[j]);
    else
      for (size_t j = 0; j < w; j++) fp_neg(FR, a[j], d[j]);
  }
  Fp4 *vo = (Fp4 *)out;
  for (size_t o = 0; o < nout; o++)
    for (size_t j = 0; j < w; j++)
      fp_from_mont(FR, buf[(size_t)out_slots[o] * w + j], vo[o * n + lo + j]);
}

// Pointer/rotation variant: base rows are read in place from row_ptrs[b]
// with a cyclic rotation rots[b] (row value i := src[(i + rot) mod n]) and a
// stride flag (strides[b] == 0 -> 1-element constant row broadcast).  Kills
// the caller-side np.roll / 200-MB stack copies that dominated the Python
// quotient_eval wrapper (round-5 profile).
void h2t_expr_eval_fr_rows(const u64 *const *row_ptrs, const int32_t *rots,
                           const int32_t *strides, size_t nbase, size_t n,
                           const int32_t *instrs, size_t ni,
                           const int32_t *out_slots, size_t nout, u64 *out) {
  size_t chunk = (2u << 20) / ((nbase + ni) * 40 + 1);
  chunk &= ~(size_t)7;
  if (chunk < 16) chunk = 16;
  if (chunk > n) chunk = n;
  size_t nchunks = (n + chunk - 1) / chunk;
  int nt = num_threads();
  if ((size_t)nt > nchunks) nt = (int)nchunks;
  // expr_eval_chunk writes outputs at out[o*n + lo + j]; run it with its
  // own n = w over a chunk-local buffer and copy into the real out rows.
  auto run2 = [&](size_t ci) {
    size_t lo = ci * chunk, hi = lo + chunk < n ? lo + chunk : n;
    size_t w = hi - lo;
    std::vector<Fp4> cb(nbase * w);
    for (size_t b = 0; b < nbase; b++) {
      const Fp4 *src = (const Fp4 *)row_ptrs[b];
      Fp4 *dst = cb.data() + b * w;
      if (strides[b] == 0) {
        for (size_t j = 0; j < w; j++) dst[j] = src[0];
        continue;
      }
      size_t start = ((size_t)((rots[b] % (int64_t)n + (int64_t)n)) + lo) % n;
      size_t first = n - start < w ? n - start : w;
      memcpy(dst, src + start, 32 * first);
      if (first < w) memcpy(dst + first, src, 32 * (w - first));
    }
    std::vector<Fp4> cout(nout * w);
    expr_eval_chunk((const u64 *)cb.data(), nbase, w, 0, w, instrs, ni,
                    out_slots, nout, (u64 *)cout.data());
    for (size_t o = 0; o < nout; o++)
      memcpy(out + 4 * (o * n + lo), cout.data() + o * w, 32 * w);
  };
  if (nt <= 1) {
    for (size_t ci = 0; ci < nchunks; ci++) run2(ci);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++)
    threads.emplace_back([&, t]() {
      for (size_t ci = t; ci < nchunks; ci += (size_t)nt) run2(ci);
    });
  for (auto &th : threads) th.join();
}

void h2t_expr_eval_fr(const u64 *base, size_t nbase, size_t n,
                      const int32_t *instrs, size_t ni,
                      const int32_t *out_slots, size_t nout, u64 *out) {
  // Small column chunks keep the whole (nbase + ni)-slot buffer inside the
  // cache hierarchy: at the flagship's ~1100 slots a per-thread half-split
  // buffer is ~150 MB (DRAM-streamed on every instruction); 64-wide chunks
  // are ~2 MB.  Threads stride over chunks.
  size_t chunk = (2u << 20) / ((nbase + ni) * 40 + 1);
  chunk &= ~(size_t)7;  // IFMA lanes want multiples of 8
  if (chunk < 16) chunk = 16;
  if (chunk > n) chunk = n;
  size_t nchunks = (n + chunk - 1) / chunk;
  int nt = num_threads();
  if ((size_t)nt > nchunks) nt = (int)nchunks;
  auto run = [&](size_t ci) {
    size_t lo = ci * chunk, hi = lo + chunk < n ? lo + chunk : n;
    expr_eval_chunk(base, nbase, n, lo, hi, instrs, ni, out_slots, nout, out);
  };
  if (nt <= 1) {
    for (size_t ci = 0; ci < nchunks; ci++) run(ci);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++)
    threads.emplace_back([&, t]() {
      for (size_t ci = t; ci < nchunks; ci += (size_t)nt) run(ci);
    });
  for (auto &th : threads) th.join();
}

// acc[i] += b[i] * s for a scalar s (canonical in/out).  The multiopen's
// poly_add_scaled over (n, 4) host polys.
void h2t_axpy_fr(u64 *acc, const u64 *b, const u64 *s, size_t n) {
  Fp4 sm;
  fp_to_mont(FR, *(const Fp4 *)s, sm);
  Fp4 *va = (Fp4 *)acc;
  const Fp4 *vb = (const Fp4 *)b;
  size_t i = 0;
#ifdef H2T_IFMA
  {
    const Ctx52 &C = fr52();
    Fp4 s_canon = *(const Fp4 *)s;
    u64 s52[5];
    scalar_to_mont52(C, s_canon, s52);
    V52 sv;
    v52_bcast_elem(s52, sv);
    for (; i + 8 <= n; i += 8) {
      V52 x, y;
      v52_load_mont(C, vb + i, x);
      v52_mul(C, x, sv, x);
      v52_load_mont(C, va + i, y);
      v52_add(C, x, y, x);
      v52_store_canon(C, x, va + i);
    }
  }
#endif
  for (; i < n; i++) {
    Fp4 bm, t;
    fp_to_mont(FR, vb[i], bm);
    fp_mul(FR, bm, sm, t);
    Fp4 am;
    fp_to_mont(FR, va[i], am);
    fp_add(FR, am, t, am);
    fp_from_mont(FR, am, va[i]);
  }
}

// out[j] = sum_i rows[i][j] * factors[i] (canonical).  The prover's h-piece
// fold h(X) = sum x^{n i} h_i(X).
void h2t_fold_scaled_fr(const u64 *rows, size_t nh, size_t n,
                        const u64 *factors, u64 *out) {
  memset(out, 0, 32 * n);
  for (size_t i = 0; i < nh; i++)
    h2t_axpy_fr(out, rows + 4 * n * i, factors + 4 * i, n);
}

// In-place synthetic division f /= divisor (monic-ized internally); returns
// 0 when the remainder is zero, 1 otherwise.  f: nf coeffs ascending;
// divisor: nd coeffs (nd small — the multiopen divides by vanishing factors
// of degree <= |T|).  Quotient lands in f[0 .. nf-nd], remainder in f[0..nd-2].
int h2t_poly_div_fr(u64 *f, size_t nf, const u64 *divisor, size_t nd) {
  if (nd == 0 || nf < nd) return 1;
  size_t d = nd - 1;
  Fp4 *vf = (Fp4 *)f;
  const Fp4 *vd = (const Fp4 *)divisor;
  Fp4 lead_m, lead_inv;
  fp_to_mont(FR, vd[d], lead_m);
  fp_inv(FR, lead_m, lead_inv);
  std::vector<Fp4> div_m(d);  // -divisor[j] / lead, Montgomery
  for (size_t j = 0; j < d; j++) {
    Fp4 t;
    fp_to_mont(FR, vd[j], t);
    fp_mul(FR, t, lead_inv, t);
    fp_neg(FR, t, div_m[j]);
  }
  // work in Montgomery over the whole buffer once
  for (size_t i = 0; i < nf; i++) fp_to_mont(FR, vf[i], vf[i]);
  for (size_t i = nf; i-- > d;) {
    Fp4 q;
    fp_mul(FR, vf[i], lead_inv, q);
    vf[i] = q;
    for (size_t j = 0; j < d; j++) {
      Fp4 t;
      fp_mul(FR, q, div_m[j], t);
      fp_add(FR, vf[i - d + j], t, vf[i - d + j]);
    }
  }
  int rem = 0;
  for (size_t j = 0; j < d; j++)
    if (!fp_is_zero(vf[j])) rem = 1;
  // shift quotient down to f[0..]
  for (size_t i = 0; i + d < nf; i++) fp_from_mont(FR, vf[i + d], vf[i]);
  memset(vf + (nf - d), 0, 32 * d);
  return rem;
}

// Pairing product check: returns 1 iff prod_i e(P_i, Q_i) == 1.
// pairs: npairs * 24 u64 = per pair [px(4), py(4), qx0(4), qx1(4), qy0(4),
// qy1(4)] canonical; a pair with P == (0,0) or Q == (0,...,0) is skipped
// (infinity), matching ec/host.py pairing_product_is_one.
// fexp: little-endian u64 words of the final exponent (p^12 - 1)/r,
// computed host-side (the easy/hard split is unnecessary at this budget:
// the whole check runs in ~30 ms).
int h2t_pairing_product_is_one(const u64 *pairs, size_t npairs,
                               const u64 *fexp, size_t nw) {
  Fq12 f;
  fq12_one(f);
  bool any = false;
  for (size_t i = 0; i < npairs; i++) {
    const u64 *e = pairs + 24 * i;
    Fp4 px, py;
    memcpy(px.l, e, 32);
    memcpy(py.l, e + 4, 32);
    Fq2 qx, qy;
    memcpy(qx.c0.l, e + 8, 32);
    memcpy(qx.c1.l, e + 12, 32);
    memcpy(qy.c0.l, e + 16, 32);
    memcpy(qy.c1.l, e + 20, 32);
    if (fp_is_zero(px) && fp_is_zero(py)) continue;
    if (fq2_is_zero(qx) && fq2_is_zero(qy)) continue;
    // each pair's Miller loop runs on its OWN accumulator (the in-loop
    // squarings must not touch the previous pairs' product)
    Fq12 fi;
    fq12_one(fi);
    miller_accumulate(px, py, qx, qy, fi);
    fq12_mul(f, fi, f);
    any = true;
  }
  if (!any) return 1;
  Fq12 out;
  fq12_pow_words(f, fexp, nw, out);
  return fq12_is_one(out) ? 1 : 0;
}

// Miller loop value (NO final exponentiation) of one pair -> 12 Fq
// components (canonical), in the DIRECT basis of ec/host.py's FQ12
// (coefficients of w^0..w^11) so the two implementations can be
// cross-checked coefficient-by-coefficient (tests/test_native.py).
// Tower -> direct: element = sum_{j<6} (c[j].c0 + c[j].c1 * i) * w^perm(j)
// with i = w^6 - 9, so direct[k] picks up c.c0 at w^k and c.c1 at w^(k+6)
// minus 9*c.c1 at w^k.
void h2t_pairing(const u64 *p_xy, const u64 *q_xyxy, u64 *out12) {
  Fp4 px, py;
  memcpy(px.l, p_xy, 32);
  memcpy(py.l, p_xy + 4, 32);
  Fq2 qx, qy;
  memcpy(qx.c0.l, q_xyxy, 32);
  memcpy(qx.c1.l, q_xyxy + 4, 32);
  memcpy(qy.c0.l, q_xyxy + 8, 32);
  memcpy(qy.c1.l, q_xyxy + 12, 32);
  Fq12 f;
  fq12_one(f);
  if (!(fp_is_zero(px) && fp_is_zero(py)) &&
      !(fq2_is_zero(qx) && fq2_is_zero(qy)))
    miller_accumulate(px, py, qx, qy, f);
  // tower coefficient j (over Fq2) sits at w^deg: c0 rows deg 0,2,4;
  // c1 rows deg 1,3,5 (w^1, w^3, w^5)
  const Fq2 *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2,
                      &f.c1.c0, &f.c1.c1, &f.c1.c2};
  const int degs[6] = {0, 2, 4, 1, 3, 5};
  Fp4 direct[12];
  memset(direct, 0, sizeof(direct));
  Fp4 nine = {{9, 0, 0, 0}};
  fp_to_mont(FQ, nine, nine);
  for (int j = 0; j < 6; j++) {
    int d = degs[j];
    Fp4 t;
    fp_mul(FQ, cs[j]->c1, nine, t);
    Fp4 lo;
    fp_sub(FQ, cs[j]->c0, t, lo);          // c0 - 9 c1 at w^d
    fp_add(FQ, direct[d], lo, direct[d]);
    fp_add(FQ, direct[d + 6], cs[j]->c1, direct[d + 6]);  // c1 at w^(d+6)
  }
  for (int k = 0; k < 12; k++) {
    Fp4 c;
    fp_from_mont(FQ, direct[k], c);
    memcpy(out12 + 4 * k, c.l, 32);
  }
}

// Horner evaluation: out[j] = poly(x[j]) for q points (canonical in/out).
void h2t_poly_eval_fr(const u64 *poly, size_t n, const u64 *x, size_t q,
                      u64 *out) {
  const Fp4 *vp = (const Fp4 *)poly;
  for (size_t j = 0; j < q; j++) {
    Fp4 xm, acc = {{0, 0, 0, 0}};
    fp_to_mont(FR, ((const Fp4 *)x)[j], xm);
    for (size_t i = n; i-- > 0;) {
      Fp4 cm;
      fp_to_mont(FR, vp[i], cm);
      fp_mul(FR, acc, xm, acc);
      fp_add(FR, acc, cm, acc);
    }
    fp_from_mont(FR, acc, ((Fp4 *)out)[j]);
  }
}

}  // extern "C"

// BN254 G1 group law for one thread a lane: dbl-2009-l, the mixed add
// madd-2007-bl and the complete add add-2007-bl, with the exceptions of the
// reference's canonical formulas (halo2_tpu/ec/device.py:jac_double,
// :_jac_madd_jnp and :_jac_add_jnp; P == Q doubles); and the doubling and
// the complete add for a group of four threads a lane (at the end).
// Shared by jac.cu's, msm.cu's and ladder.cu's kernels.  Every value stays
// canonical (< p), so each result equals the plain versions
// (ec/cuda_jac.py) limb for limb.
//
// A point is three 8-word elements (k = 0, 1, 2: x, y, z), Montgomery form
// over BN254 Fq; z == 0 marks infinity.  The formulas read a point through
// a source (load(k, v)) and write the result through a sink (store(k, v)),
// so one formula serves a point in device memory, read when the formula
// needs each coordinate and written as soon as a coordinate is final (the
// wide kernels: fewer live registers), and a point held in registers (the
// MSM kernels' accumulators).
#pragma once

#include "field_cc.cuh"

namespace h2t {

// A point in registers.
struct Jac {
  uint32_t c[3][WORDS];
};

// Source and sink of a point in registers.
struct RegPoint {
  const Jac* p;
  __device__ __forceinline__ void load(int k, uint32_t v[WORDS]) const {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) v[j] = p->c[k][j];
  }
};
struct RegOut {
  Jac* p;
  __device__ __forceinline__ void store(int k, const uint32_t v[WORDS]) const {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) p->c[k][j] = v[j];
  }
};

// Source and sink of a point in device memory: (16, ld) limb arrays, one a
// coordinate, at element i.
struct GlobalPoint {
  const uint32_t* c[3];
  size_t ld, i;
  __device__ __forceinline__ void load(int k, uint32_t v[WORDS]) const { load_elem(c[k], ld, i, v); }
};
struct GlobalOut {
  uint32_t* c[3];
  size_t ld, i;
  __device__ __forceinline__ void store(int k, const uint32_t v[WORDS]) const { store_elem(c[k], ld, i, v); }
};

template <class O>
__device__ __forceinline__ void store_infinity(const O& out, const ModulusOne& C) {  // (0, 1, 0)
  const uint32_t zero[WORDS] = {};
  out.store(0, zero);
  out.store(1, C.one);
  out.store(2, zero);
}

// 2 (x, y, z), dbl-2009-l as ec/device.py:jac_double computes it.
template <class O>
__device__ __forceinline__ void jac_dbl_into(const uint32_t x[WORDS], const uint32_t y[WORDS],
                                             const uint32_t z[WORDS], const Modulus& M, const O& out) {
  uint32_t a[WORDS], b[WORDS], c[WORDS], t[WORDS], dd[WORDS], e[WORDS];
  cc::sqr(x, M, a);
  cc::sqr(y, M, b);
  cc::sqr(b, M, c);
  cc::add(x, b, M, t);
  cc::sqr(t, M, t);
  cc::sub(t, a, M, t);
  cc::sub(t, c, M, t);
  cc::dbl(t, M, dd);  // dd = 2((x + b)^2 - a - c)
  cc::dbl(a, M, e);
  cc::add(e, a, M, e);  // e = 3a
  cc::sqr(e, M, t);  // f = e^2
  cc::dbl(dd, M, b);
  cc::sub(t, b, M, t);  // x3 = f - 2 dd
  cc::sub(dd, t, M, a);
  out.store(0, t);
  cc::mul(e, a, M, t);
  cc::dbl(c, M, c);
  cc::dbl(c, M, c);
  cc::dbl(c, M, c);
  cc::sub(t, c, M, t);  // y3 = e (dd - x3) - 8c
  cc::mul(y, z, M, a);
  out.store(1, t);
  cc::dbl(a, M, t);  // z3 = 2 y z
  out.store(2, t);
}

// x3 = rr^2 - j - 2v and y3 = rr (v - x3) - 2 w j, the tail both adds share
// (w is y1 for the mixed add, s1 for the full add).
__device__ __forceinline__ void add_tail(const uint32_t rr[WORDS], const uint32_t j[WORDS],
                                         const uint32_t v[WORDS], const uint32_t w[WORDS],
                                         const Modulus& M, uint32_t x3[WORDS],
                                         uint32_t y3[WORDS]) {
  uint32_t t[WORDS], u[WORDS];
  cc::sqr(rr, M, t);
  cc::sub(t, j, M, t);
  cc::dbl(v, M, u);
  cc::sub(t, u, M, x3);
  cc::sub(v, x3, M, t);
  cc::mul(rr, t, M, t);
  cc::mul(w, j, M, u);
  cc::dbl(u, M, u);
  cc::sub(t, u, M, y3);
}

// p + (qx, qy), madd-2007-bl: 8 multiplies and 3 squares, z3 taken as 2 z1 h
// (the plain versions' (z1 + h)^2 - z1z1 - h^2: the same field element, and
// z1, z1z1 and h^2 need not live to the end).  (qx, qy) is a finite affine
// point (z = 1); p at infinity gives (qx, qy, 1), P == Q the doubling of p,
// P == -Q z = 0.
template <class P, class O>
__device__ __forceinline__ void jac_madd_into(const P& p, const uint32_t qx[WORDS], const uint32_t qy[WORDS],
                                              const ModulusOne& C, const O& out) {
  const Modulus& M = C.M;
  uint32_t z1[WORDS];
  p.load(2, z1);
  if (is_zero(z1)) {  // p at infinity: the result is (qx, qy, 1)
    out.store(0, qx);
    out.store(1, qy);
    out.store(2, C.one);
    return;
  }
  uint32_t z1z1[WORDS], h[WORDS], hh[WORDS], i4[WORDS], j[WORDS], rr[WORDS], v[WORDS];
  uint32_t t[WORDS], u[WORDS], x1[WORDS], y1[WORDS];
  cc::sqr(z1, M, z1z1);
  cc::mul(qx, z1z1, M, u);  // u2
  p.load(0, x1);
  cc::sub(u, x1, M, h);
  cc::mul(z1, z1z1, M, t);
  cc::mul(qy, t, M, u);  // s2
  p.load(1, y1);
  cc::sub(u, y1, M, t);
  cc::dbl(t, M, rr);
  if (is_zero(h) && is_zero(rr)) {  // P == Q
    jac_dbl_into(x1, y1, z1, M, out);
    return;
  }
  cc::mul(z1, h, M, t);  // z3 = 2 z1 h; p's z is not read again
  cc::dbl(t, M, t);
  out.store(2, t);
  cc::sqr(h, M, hh);
  cc::dbl(hh, M, i4);
  cc::dbl(i4, M, i4);
  cc::mul(h, i4, M, j);
  cc::mul(x1, i4, M, v);
  uint32_t x3[WORDS], y3[WORDS];
  add_tail(rr, j, v, y1, M, x3, y3);
  out.store(0, x3);
  out.store(1, y3);
}

// p + q, complete: p or q at infinity returns the other (q is checked
// first, as the reference's last select), P == -Q gives infinity (0, 1, 0),
// P == Q doubles.  add-2007-bl: 12 multiplies and 4 squares.
template <class P, class Q, class O>
__device__ __forceinline__ void jac_add_into(const P& p, const Q& q, const ModulusOne& C, const O& out) {
  const Modulus& M = C.M;
  uint32_t z1[WORDS], z2[WORDS], t[WORDS], u[WORDS];
  p.load(2, z1);
  q.load(2, z2);
  if (is_zero(z2)) {  // q at infinity: p
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p.load(k, t);
      out.store(k, t);
    }
    return;
  }
  if (is_zero(z1)) {  // p at infinity: q
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      q.load(k, t);
      out.store(k, t);
    }
    return;
  }
  uint32_t z1z1[WORDS], z2z2[WORDS], s1[WORDS];
  cc::sqr(z1, M, z1z1);
  cc::sqr(z2, M, z2z2);
  p.load(1, t);
  cc::mul(t, z2, M, t);
  cc::mul(t, z2z2, M, s1);  // s1 = y1 z2 z2z2
  q.load(1, t);
  cc::mul(t, z1, M, t);
  cc::mul(t, z1z1, M, u);  // s2 = y2 z1 z1z1
  uint32_t r[WORDS];
  cc::sub(u, s1, M, r);
  uint32_t u1[WORDS], h[WORDS];
  p.load(0, t);
  cc::mul(t, z2z2, M, u1);
  q.load(0, t);
  cc::mul(t, z1z1, M, u);  // u2
  cc::sub(u, u1, M, h);
  if (is_zero(h)) {
    if (is_zero(r)) {  // P == Q
      p.load(0, t);
      p.load(1, u);
      jac_dbl_into(t, u, z1, M, out);
    } else {  // P == -Q: infinity
      store_infinity(out, C);
    }
    return;
  }
  uint32_t i4[WORDS], j[WORDS], v[WORDS], rr[WORDS];
  cc::mul(z1, z2, M, t);  // z3 = 2 z1 z2 h
  cc::dbl(t, M, t);
  cc::mul(t, h, M, t);
  out.store(2, t);
  cc::sqr(h, M, t);  // hh
  cc::dbl(t, M, i4);
  cc::dbl(i4, M, i4);
  cc::mul(h, i4, M, j);
  cc::dbl(r, M, rr);
  cc::mul(u1, i4, M, v);
  uint32_t x3[WORDS], y3[WORDS];
  add_tail(rr, j, v, s1, M, x3, y3);
  out.store(0, x3);
  out.store(1, y3);
}

// ------------------------------------------------- four threads a point
// The group law on a group of GROUP = 4 threads of one warp, a point held
// in every thread of its group: at each level of a formula every thread runs
// the same product on the operands its rank g in the group picks (selects,
// not branches, so the warp never diverges), and the group trades the
// results by __shfl_sync.  A doubling's chain is 3 products, an add's 5, a
// mixed add's 4 (its adds and subtracts spread over the ranks too),
// against 7, 16 and 11 in one thread; the values are those of
// jac_dbl_into, jac_add_into and jac_madd_into, so a kernel on them equals
// the plain versions limb for limb.  Every thread of a warp must call them
// together (the shuffles and the P == Q vote span the warp).  jac.cu's
// jac_horner and msm.cu's cluster scan run on the first two, msm.cu's
// group schedule of msm_chunk_acc on the mixed add.  What it buys: a lane's
// chain of dependent products is 4 instead of 11, for 16 products issued a
// lane instead of 11, so a launch whose lanes leave the card half idle (one
// scalar set's 8,192 chunks) gets four times the warps and a shorter
// chain, and one whose lanes already fill the IMAD pipes is better off on
// one thread a lane.
constexpr int GROUP = 4;

// r = v of the group's thread src, in every thread of the group.
__device__ __forceinline__ void from(const uint32_t v[WORDS], int src, uint32_t r[WORDS]) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k) r[k] = __shfl_sync(0xFFFFFFFFu, v[k], src, GROUP);
}

// r = v_g for this thread's rank g in its group.
__device__ __forceinline__ void pick(int g, const uint32_t v0[WORDS], const uint32_t v1[WORDS],
                                     const uint32_t v2[WORDS], const uint32_t v3[WORDS], uint32_t r[WORDS]) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k) r[k] = g == 0 ? v0[k] : g == 1 ? v1[k] : g == 2 ? v2[k] : v3[k];
}

// (x, y, z) = 2 (x, y, z), dbl-2009-l, over the group (g: this thread's
// rank): x^2 | y^2 | y z, then b^2 | (x + b)^2 | (3a)^2, then e (dd - x3).
__device__ __forceinline__ void dbl_group(int g, uint32_t x[WORDS], uint32_t y[WORDS], uint32_t z[WORDS],
                                          const ModulusOne& K) {
  const Modulus& M = K.M;
  uint32_t u[WORDS], v[WORDS], pr[WORDS], a[WORDS], b[WORDS], yz[WORDS];
  pick(g, x, y, y, x, u);
  pick(g, x, y, z, x, v);
  cc::mul(u, v, M, pr);
  from(pr, 0, a);
  from(pr, 1, b);
  from(pr, 2, yz);
  uint32_t e[WORDS], c[WORDS], f[WORDS], dd[WORDS];
  cc::add(x, b, M, v);  // x + b
  cc::dbl(a, M, e);
  cc::add(e, a, M, e);  // e = 3a
  pick(g, b, v, e, b, u);
  cc::mul(u, u, M, pr);
  from(pr, 0, c);  // c = b^2
  from(pr, 1, v);  // (x + b)^2
  from(pr, 2, f);  // f = e^2
  cc::sub(v, a, M, v);
  cc::sub(v, c, M, v);
  cc::dbl(v, M, dd);  // dd = 2((x + b)^2 - a - c)
  cc::dbl(dd, M, u);
  cc::sub(f, u, M, x);  // x3 = f - 2 dd
  cc::sub(dd, x, M, u);
  cc::mul(e, u, M, pr);
  cc::dbl(c, M, c);
  cc::dbl(c, M, c);
  cc::dbl(c, M, c);
  cc::sub(pr, c, M, y);  // y3 = e (dd - x3) - 8c
  cc::dbl(yz, M, z);     // z3 = 2 y z
}

// (x1, y1, z1) = (x1, y1, z1) + (x2, y2, z2) over the group, complete:
// add-2007-bl in five levels of products (z1^2 | z2^2 | y1 z2 | y2 z1, u1 |
// u2 | s1 | s2, h^2 | z1 z2 | rr^2, j | z3 | v, rr (v - x3) | s1 j) with
// the exceptions of _jac_add_jnp: q at infinity gives p, p at infinity q,
// P == Q the doubling of p, P == -Q (0, 1, 0).
__device__ __forceinline__ void add_group(int g, uint32_t x1[WORDS], uint32_t y1[WORDS], uint32_t z1[WORDS],
                                          const uint32_t x2[WORDS], const uint32_t y2[WORDS],
                                          const uint32_t z2[WORDS], const ModulusOne& K) {
  const Modulus& M = K.M;
  uint32_t u[WORDS], v[WORDS], pr[WORDS];
  uint32_t z1z1[WORDS], z2z2[WORDS], y1z2[WORDS], y2z1[WORDS];
  pick(g, z1, z2, y1, y2, u);
  pick(g, z1, z2, z2, z1, v);
  cc::mul(u, v, M, pr);
  from(pr, 0, z1z1);
  from(pr, 1, z2z2);
  from(pr, 2, y1z2);
  from(pr, 3, y2z1);
  uint32_t u1[WORDS], s1[WORDS], h[WORDS], rd[WORDS];
  pick(g, x1, x2, y1z2, y2z1, u);
  pick(g, z2z2, z1z1, z2z2, z1z1, v);
  cc::mul(u, v, M, pr);
  from(pr, 0, u1);
  from(pr, 1, h);   // u2
  from(pr, 2, s1);
  from(pr, 3, rd);  // s2
  cc::sub(h, u1, M, h);    // h = u2 - u1
  cc::sub(rd, s1, M, rd);  // r = s2 - s1
  uint32_t rr[WORDS], hh[WORDS], zz[WORDS], rr2[WORDS];
  cc::dbl(rd, M, rr);
  pick(g, h, z1, rr, h, u);
  pick(g, h, z2, rr, h, v);
  cc::mul(u, v, M, pr);
  from(pr, 0, hh);
  from(pr, 1, zz);   // z1 z2
  from(pr, 2, rr2);  // rr^2
  uint32_t i4[WORDS], j[WORDS], z3[WORDS], vv[WORDS];
  cc::dbl(hh, M, i4);
  cc::dbl(i4, M, i4);
  cc::dbl(zz, M, zz);
  pick(g, h, zz, u1, h, u);
  pick(g, i4, h, i4, i4, v);
  cc::mul(u, v, M, pr);
  from(pr, 0, j);    // j = h i
  from(pr, 1, z3);   // z3 = 2 z1 z2 h
  from(pr, 2, vv);   // v = u1 i
  uint32_t x3[WORDS], y3[WORDS];
  cc::sub(rr2, j, M, x3);
  cc::dbl(vv, M, u);
  cc::sub(x3, u, M, x3);  // x3 = rr^2 - j - 2v
  cc::sub(vv, x3, M, v);
  pick(g, rr, s1, rr, rr, u);
  pick(g, v, j, v, v, v);
  cc::mul(u, v, M, pr);
  from(pr, 0, y3);  // rr (v - x3)
  from(pr, 1, u);   // s1 j
  cc::dbl(u, M, u);
  cc::sub(y3, u, M, y3);  // y3 = rr (v - x3) - 2 s1 j
  const bool q_inf = is_zero(z2), p_inf = is_zero(z1);
  const bool h_zero = is_zero(h), r_zero = is_zero(rd);
  const bool same = !q_inf && !p_inf && h_zero && r_zero;
  uint32_t dx[WORDS], dy[WORDS], dz[WORDS];
  if (__any_sync(0xFFFFFFFFu, same)) {  // uniform over the warp: the shuffles need every thread
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      dx[k] = x1[k];
      dy[k] = y1[k];
      dz[k] = z1[k];
    }
    dbl_group(g, dx, dy, dz, K);
  }
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    if (q_inf) continue;  // p
    if (p_inf) {  // q
      x1[k] = x2[k];
      y1[k] = y2[k];
      z1[k] = z2[k];
    } else if (h_zero && r_zero) {  // P == Q
      x1[k] = dx[k];
      y1[k] = dy[k];
      z1[k] = dz[k];
    } else if (h_zero) {  // P == -Q: infinity (0, 1, 0)
      x1[k] = 0;
      y1[k] = K.one[k];
      z1[k] = 0;
    } else {
      x1[k] = x3[k];
      y1[k] = y3[k];
      z1[k] = z3[k];
    }
  }
}

// (x1, y1, z1) = (x1, y1, z1) + (qx, qy) over the group, (qx, qy) a finite
// affine point: madd-2007-bl in four levels of products, and the adds and
// subtracts between them spread over the ranks as well, one of a kind a
// step (each rank the same instruction on the operands it picks, or
// receives by a shuffle from the rank that holds them):
//   L1 z1^2 | qy z1 | qx y1 | -              (2 x1 on every rank)
//   L2 u2 = qx z1z1 | s2 = qy z1 z1z1 | t = qx y1 z1z1 | x1 y1
//   A  h = u2 - x1 | s2 - y1 | h y1 = t - x1 y1 | h
//   B  w = u2 + 2 x1 | rr = 2 (s2 - y1) | 2 h y1 | 2 h
//   L3 i = (2 h)^2 | rr^2 | rr w | z3 = z1 (2 h)
//   E  - | - | b = rr w - 2 h y1 | -
//   L4 j = h i | 2 v = (2 x1) i | i b | rr rr^2
//   G  - | rr^2 - j | y3 = i b - rr^3 | -
//   H  - | x3 = rr^2 - j - 2 v | - | -
// then x3, y3 and z3 go to every rank.  jac_madd_into's i = 4 h^2, y3 =
// rr (v - x3) - 2 y1 j = 3 rr v - rr^3 + j (rr - 2 y1) = i b - rr^3 (w = 3
// x1 + h) and z3 = (z1 + h)^2 - z1z1 - h^2 = 2 z1 h rearranged: the same
// field elements, so the same canonical limbs.  Exceptions as
// jac_madd_into: p at infinity gives (qx, qy, 1), P == Q the doubling of p,
// P == -Q z3 = 0 with x3 = rr^2 and y3 = -rr^3.  A thread issues 4 products
// and 6 adds or subtracts a madd, against 11 and 16 in one thread.
__device__ __forceinline__ void madd_group(int g, uint32_t x1[WORDS], uint32_t y1[WORDS], uint32_t z1[WORDS],
                                           const uint32_t qx[WORDS], const uint32_t qy[WORDS],
                                           const ModulusOne& K) {
  const Modulus& M = K.M;
  uint32_t a[WORDS], b[WORDS], pr[WORDS], o[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = g == 1 ? qy[k] : g == 2 ? qx[k] : z1[k];
    b[k] = g == 2 ? y1[k] : z1[k];
  }
  cc::mul(a, b, M, pr);  // L1
  uint32_t x2[WORDS];
  cc::add(x1, x1, M, x2);
  from(pr, 0, o);  // z1z1
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = g == 0 ? qx[k] : g == 3 ? x1[k] : pr[k];
    b[k] = g == 3 ? y1[k] : o[k];
  }
  cc::mul(a, b, M, pr);  // L2
  from(pr, g == 2 ? 3 : g == 3 ? 0 : g, o);  // u2 | s2 | x1 y1 | u2
  uint32_t ra[WORDS], rb[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = g == 2 ? pr[k] : o[k];
    b[k] = g == 1 ? y1[k] : g == 2 ? o[k] : x1[k];
  }
  cc::sub(a, b, M, ra);  // A
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = g == 0 ? o[k] : ra[k];
    b[k] = g == 0 ? x2[k] : ra[k];
  }
  cc::add(a, b, M, rb);  // B
  const bool h_zero = __shfl_sync(0xFFFFFFFFu, is_zero(ra), 0, GROUP);
  const bool r_zero = __shfl_sync(0xFFFFFFFFu, is_zero(rb), 1, GROUP);
  uint32_t rr[WORDS];
  from(rb, g == 0 ? 3 : 1, rr);  // 2 h | rr | rr | rr
  from(rb, 0, o);                // w
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = g == 3 ? z1[k] : rr[k];
    b[k] = g == 2 ? o[k] : g == 3 ? rb[k] : rr[k];
  }
  cc::mul(a, b, M, pr);  // L3
  uint32_t p3[WORDS], e[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) p3[k] = pr[k];  // rr^2 on rank 1, z3 on rank 3
  cc::sub(pr, rb, M, e);  // E
  from(pr, g == 3 ? 1 : 0, o);  // i | i | i | rr^2
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    a[k] = g == 0 ? ra[k] : g == 1 ? x2[k] : g == 2 ? o[k] : rr[k];
    b[k] = g == 2 ? e[k] : o[k];
  }
  cc::mul(a, b, M, pr);  // L4
  from(pr, g == 1 ? 0 : 3, o);  // - | j | rr^3 | -
#pragma unroll
  for (int k = 0; k < WORDS; ++k) a[k] = g == 1 ? p3[k] : pr[k];
  cc::sub(a, o, M, b);   // G
  cc::sub(b, pr, M, a);  // H
  uint32_t x3[WORDS], y3[WORDS], z3[WORDS];
  from(a, 1, x3);
  from(b, 2, y3);
  from(p3, 3, z3);
  const bool p_inf = is_zero(z1);
  const bool same = !p_inf && h_zero && r_zero;
  uint32_t dx[WORDS], dy[WORDS], dz[WORDS];
  if (__any_sync(0xFFFFFFFFu, same)) {  // uniform over the warp: the shuffles need every thread
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      dx[k] = x1[k];
      dy[k] = y1[k];
      dz[k] = z1[k];
    }
    dbl_group(g, dx, dy, dz, K);
  }
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    if (p_inf) {  // (qx, qy, 1)
      x1[k] = qx[k];
      y1[k] = qy[k];
      z1[k] = K.one[k];
    } else if (same) {  // P == Q
      x1[k] = dx[k];
      y1[k] = dy[k];
      z1[k] = dz[k];
    } else {
      x1[k] = x3[k];
      y1[k] = y3[k];
      z1[k] = z3[k];
    }
  }
}

}  // namespace h2t

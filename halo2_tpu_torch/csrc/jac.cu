// BN254 G1 group law in Jacobian coordinates: the mixed add of a Jacobian
// point and an affine point (jac_madd) and the complete Jacobian add
// (jac_add), each in two variants: one thread per lane (wide) and four warps
// per 32 lanes (narrow); and the Horner combine of the sharded MSM's window
// sums in one launch (jac_horner, four threads of a warp a lane, its point
// in registers: its own note is at jac_horner_kernel below).
//
// The two adds replace halo2_tpu/ec/pallas_jac.py:_madd_kernel and :_add_kernel.  They
// compute the reference's canonical formulas, halo2_tpu/ec/device.py:
// _jac_madd_jnp (madd-2007-bl) and :_jac_add_jnp (add-2007-bl), WITH their
// P == Q branch: a finite lane whose two points are equal takes the doubling
// dbl-2009-l (ec/device.py:jac_double) inside the kernel, so the wrapper reads
// nothing back.  Every field value stays canonical (< p), so the output equals
// the plain versions (ec/cuda_jac.py) limb for limb.  The TPU kernels'
// lambda = 1/2 scaled output and lazy < 2p bounds are not carried over.
//
// Points are (16, m) int32 limb arrays per coordinate over BN254 Fq,
// Montgomery form, limb-major (field.cuh); z == 0 marks infinity.
//
// What bounds them: integer multiplies.  A lane takes 11 (madd) or 16 (add)
// Montgomery products of 64 32x32->64 multiplies plus 64 for the reduction
// (field_cc.cuh), against 516 bytes (madd: 5 coordinates of 64 bytes and a
// flag in, 3 out) or 576 bytes (add) of memory.  The design answers two
// regimes:
// - narrow calls, up to NARROW_MAX_LANES = 8,192 lanes (ec/cuda_jac.py; the
//   suffix scans' 32 to 2,816 lanes): few warps on 132 SMs, so the time is
//   one thread's chain of dependent products.  Four warps per 32 lanes split
//   each formula's independent products between them and trade the values
//   through shared memory: jac_add's chain is 5 products deep instead of 16,
//   jac_madd's 5 instead of 11, the doubling's 3 instead of 7.  (The split
//   must be across warps: four threads of one warp on four branches run one
//   after another.  CGBN's layout, 8 threads per lane with one word each and
//   the carries passed by shuffles and votes, measured about 2x slower at
//   these widths: every step of its products waits on a shuffle.)
// - wide calls, above that (the MSM's Abel combine and tree sums at a
//   batch's width): one thread per lane, every intermediate in registers,
//   the field ops as PTX carry chains that ptxas fuses into IMAD.WIDE.U32.X
//   (field_cc.cuh), and a register budget set by __launch_bounds__.  Their
//   formulas live in jac.cuh, which msm.cu's kernels share.
// The wrapper picks the variant from m.  Registers, spills and times per
// width (nvcc -Xptxas -v, CUDA 12.9, sm_90a; one H100): PERF.md.

#include "jac.cuh"

using namespace h2t;

namespace {

constexpr int WIDE_THREADS = 128;
// Blocks of WIDE_THREADS a wide kernel's SM must hold at once, which caps its
// registers at 128.  On one H100, 4 blocks (128 registers, no spills) beat 3
// (130/124 registers): jac_add at 2^20 lanes 0.3276 vs 0.3332 ms, jac_madd
// 0.2509 vs 0.2528 ms (chip_smoke.py phase 2, PERF.md).
constexpr int WIDE_MIN_BLOCKS = 4;
constexpr int NARROW_WARPS = 4;   // narrow: warps per block, one a product
constexpr int NARROW_LANES = 32;  // narrow: lanes per block
constexpr int NARROW_THREADS = NARROW_WARPS * NARROW_LANES;

// Copy lane idx of a (16, m) coordinate to the output unchanged.
__device__ __forceinline__ void copy_elem(const uint32_t* __restrict__ src,
                                          uint32_t* __restrict__ dst, size_t ld, size_t idx) {
#pragma unroll
  for (int j = 0; j < 2 * WORDS; ++j) dst[j * ld + idx] = src[j * ld + idx];
}

// ---------------------------------------------------------------- wide
// One thread per lane, on the formulas of jac.cuh, reading each coordinate
// when the formula needs it and storing each as soon as it is final.

// out = p + (qx, qy) where valid, else p.
__global__ void __launch_bounds__(WIDE_THREADS, WIDE_MIN_BLOCKS)
jac_madd_wide_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                     const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                     const uint32_t* __restrict__ qy, const int* __restrict__ valid,
                     uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                     uint32_t* __restrict__ oz, int m, ModulusOne C) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  if (!valid[idx]) {  // masked lane: p unchanged
    copy_elem(px, ox, m, idx);
    copy_elem(py, oy, m, idx);
    copy_elem(pz, oz, m, idx);
    return;
  }
  uint32_t x2[WORDS], y2[WORDS];
  load_elem(qx, m, idx, x2);
  load_elem(qy, m, idx, y2);
  jac_madd_into(GlobalPoint{{px, py, pz}, static_cast<size_t>(m), idx}, x2, y2, C,
                GlobalOut{{ox, oy, oz}, static_cast<size_t>(m), idx});
}

// out = p + q, complete.
__global__ void __launch_bounds__(WIDE_THREADS, WIDE_MIN_BLOCKS)
jac_add_wide_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz, int m, ModulusOne C) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  const size_t ld = static_cast<size_t>(m);
  jac_add_into(GlobalPoint{{px, py, pz}, ld, idx}, GlobalPoint{{qx, qy, qz}, ld, idx}, C,
               GlobalOut{{ox, oy, oz}, ld, idx});
}

// ---------------------------------------------------------------- narrow
// A block of four warps serves 32 lanes: warp w of the block works on lane
// (threadIdx.x % 32) at the w-th product of each level of the formula, so a
// lane's chain of dependent products is spread over four warps and every
// branch on w is uniform within a warp.  Products are traded through the
// block's shared slots, and __syncthreads ends each level.  Every thread
// goes through every level (lanes past m, or whose result is an exception,
// compute values nobody stores); the doubling's levels run when some lane of
// the block needs them (__syncthreads_or).  Last, warps 0, 1 and 2 store x,
// y and z of their 32 lanes, choosing per lane among the exception results.

// A block's shared values: slot s, word k of lane l at sh[s][k][l], so a
// warp's 32 lanes read consecutive banks.
struct Slots {
  uint32_t (*sh)[WORDS][NARROW_LANES];
  int lane;
  __device__ __forceinline__ void put(int s, const uint32_t v[WORDS]) const {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) sh[s][k][lane] = v[k];
  }
  __device__ __forceinline__ void get(int s, uint32_t v[WORDS]) const {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) v[k] = sh[s][k][lane];
  }
};

// The doubling's scratch slots, after each kernel's own (base).
enum DblSlot { D_A, D_B, D_C, D_T, D_F, D_X, D_Y, D_Z, D_SLOTS };

// dbl-2009-l of P over the block's four warps, into slots out, out + 1 and
// out + 2 (x, y, z): 3 levels of products (x^2, y^2, y z | b^2, (x + b)^2,
// (3a)^2 | e (dd - x3)).  out must not be P's own slots: z3 is written in
// the first level, and P's x is read again in the second.
template <class P>
__device__ __forceinline__ void dbl_narrow(const Slots& S, int base, int out, int w, const P& pt,
                                           const Modulus& M) {
  uint32_t t[WORDS], u[WORDS], v[WORDS];
  if (w == 0) {
    pt.load(0, u);
    cc::sqr(u, M, t);
    S.put(base + D_A, t);
  } else if (w == 1) {
    pt.load(1, u);
    cc::sqr(u, M, t);
    S.put(base + D_B, t);
  } else if (w == 2) {
    pt.load(1, u);
    pt.load(2, v);
    cc::mul(u, v, M, t);
    cc::dbl(t, M, t);
    S.put(out + 2, t);  // z3 = 2 y z
  }
  __syncthreads();
  if (w == 0) {
    S.get(base + D_B, u);
    cc::sqr(u, M, t);
    S.put(base + D_C, t);  // c = b^2
  } else if (w == 1) {
    S.get(base + D_B, u);
    pt.load(0, v);
    cc::add(v, u, M, t);
    cc::sqr(t, M, t);
    S.put(base + D_T, t);  // (x + b)^2
  } else if (w == 2) {
    S.get(base + D_A, u);
    cc::dbl(u, M, t);
    cc::add(t, u, M, t);
    cc::sqr(t, M, t);
    S.put(base + D_F, t);  // f = (3a)^2
  }
  __syncthreads();
  if (w == 0) {
    uint32_t a[WORDS], c[WORDS], dd[WORDS];
    S.get(base + D_A, a);
    S.get(base + D_C, c);
    S.get(base + D_T, t);
    cc::sub(t, a, M, t);
    cc::sub(t, c, M, t);
    cc::dbl(t, M, dd);
    S.get(base + D_F, t);
    cc::dbl(dd, M, u);
    cc::sub(t, u, M, t);  // x3 = f - 2 dd
    S.put(out, t);
    cc::dbl(a, M, v);
    cc::add(v, a, M, v);  // e = 3a
    cc::sub(dd, t, M, t);
    cc::mul(v, t, M, t);
    cc::dbl(c, M, c);
    cc::dbl(c, M, c);
    cc::dbl(c, M, c);
    cc::sub(t, c, M, t);  // y3 = e (dd - x3) - 8c
    S.put(out + 1, t);
  }
  __syncthreads();
}

enum MaddSlot { M_Z1Z1, M_U2, M_Z1C, M_S2, M_HH, M_ZH2, M_J, M_V, M_RR2, M_X3, M_T, M_W, M_Z3,
                M_SLOTS };

__global__ void __launch_bounds__(NARROW_THREADS)
jac_madd_narrow_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                       const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                       const uint32_t* __restrict__ qy, const int* __restrict__ valid,
                       uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                       uint32_t* __restrict__ oz, int m, ModulusOne C) {
  __shared__ uint32_t sh[M_SLOTS + D_SLOTS][WORDS][NARROW_LANES];
  const int lane = threadIdx.x % NARROW_LANES, w = threadIdx.x / NARROW_LANES;
  const size_t idx = static_cast<size_t>(blockIdx.x) * NARROW_LANES + lane;
  const bool active = idx < static_cast<size_t>(m);
  const size_t i = active ? idx : static_cast<size_t>(m) - 1;  // where to read
  const Slots S{sh, lane};
  const Modulus& M = C.M;
  // every global read up front, so their latencies overlap once: z1, x1
  // and y1 for all, qx for warp 0, qy for warp 2
  uint32_t z1[WORDS], x1[WORDS], y1[WORDS], q[WORDS], t[WORDS], u[WORDS];
  const bool is_valid = active && valid[i];
  load_elem(pz, m, i, z1);
  load_elem(px, m, i, x1);
  load_elem(py, m, i, y1);
  if (w == 0 || w == 2) load_elem(w == 0 ? qx : qy, m, i, q);
  if (w == 0) {
    cc::sqr(z1, M, t);
    S.put(M_Z1Z1, t);
  }
  __syncthreads();
  if (w == 0) {
    S.get(M_Z1Z1, u);
    cc::mul(q, u, M, t);
    S.put(M_U2, t);  // u2 = qx z1z1
  } else if (w == 1) {
    S.get(M_Z1Z1, u);
    cc::mul(z1, u, M, t);
    S.put(M_Z1C, t);  // z1^3
  }
  __syncthreads();
  uint32_t h[WORDS], rr[WORDS];
  S.get(M_U2, t);
  cc::sub(t, x1, M, h);
  if (w == 0) {
    cc::add(z1, h, M, t);
    cc::sqr(t, M, t);
    S.put(M_ZH2, t);  // (z1 + h)^2
  } else if (w == 1) {
    cc::sqr(h, M, t);
    S.put(M_HH, t);
  } else if (w == 2) {
    S.get(M_Z1C, u);
    cc::mul(q, u, M, t);
    S.put(M_S2, t);  // s2 = qy z1^3
  }
  __syncthreads();
  S.get(M_S2, t);
  cc::sub(t, y1, M, t);
  cc::dbl(t, M, rr);
  if (w == 0) {
    S.get(M_HH, t);
    cc::dbl(t, M, t);
    cc::dbl(t, M, t);
    cc::mul(h, t, M, t);
    S.put(M_J, t);  // j = h i
  } else if (w == 1) {
    S.get(M_HH, t);
    cc::dbl(t, M, t);
    cc::dbl(t, M, t);
    cc::mul(x1, t, M, t);
    S.put(M_V, t);  // v = x1 i
  } else if (w == 2) {
    cc::sqr(rr, M, t);
    S.put(M_RR2, t);
  } else {
    S.get(M_ZH2, t);
    S.get(M_Z1Z1, u);
    cc::sub(t, u, M, t);
    S.get(M_HH, u);
    cc::sub(t, u, M, t);
    S.put(M_Z3, t);  // z3 = (z1 + h)^2 - z1z1 - hh
  }
  __syncthreads();
  if (w == 0) {
    uint32_t v[WORDS];
    S.get(M_RR2, t);
    S.get(M_J, u);
    cc::sub(t, u, M, t);
    S.get(M_V, v);
    cc::dbl(v, M, u);
    cc::sub(t, u, M, t);  // x3 = rr^2 - j - 2v
    S.put(M_X3, t);
    cc::sub(v, t, M, t);
    cc::mul(rr, t, M, t);
    S.put(M_T, t);  // rr (v - x3)
  } else if (w == 1) {
    S.get(M_J, u);
    cc::mul(y1, u, M, t);
    S.put(M_W, t);  // y1 j
  }
  const bool p_inf = is_zero(z1);
  const bool same = is_valid && !p_inf && is_zero(h) && is_zero(rr);
  if (__syncthreads_or(same)) {
    dbl_narrow(S, M_SLOTS, M_SLOTS + D_X, w, GlobalPoint{{px, py, pz}, static_cast<size_t>(m), i}, M);
  }
  if (!active || w >= 3) return;
  const uint32_t* p_in[3] = {px, py, pz};
  uint32_t* out[3] = {ox, oy, oz};
  if (!is_valid) {  // masked lane: p unchanged
    copy_elem(p_in[w], out[w], m, idx);
    return;
  }
  if (p_inf) {  // p at infinity: (qx, qy, 1)
    if (w == 2) store_elem(oz, m, idx, C.one);
    else copy_elem(w == 0 ? qx : qy, out[w], m, idx);
    return;
  }
  if (same) {
    S.get(M_SLOTS + D_X + w, t);
  } else if (w == 0) {
    S.get(M_X3, t);
  } else if (w == 1) {
    S.get(M_T, t);
    S.get(M_W, u);
    cc::dbl(u, M, u);
    cc::sub(t, u, M, t);  // y3 = rr (v - x3) - 2 y1 j
  } else {
    S.get(M_Z3, t);
  }
  store_elem(out[w], m, idx, t);
}

enum AddSlot { A_Z1Z1, A_Z2Z2, A_Y1Z2, A_Y2Z1, A_U1, A_U2, A_S1, A_S2, A_HH, A_RR2, A_J, A_V,
               A_X3, A_T, A_W, A_Z3, A_SLOTS };

// p + q over the block's four warps (add-2007-bl, with the exception cases
// of _jac_add_jnp), using slots 0 .. A_SLOTS + D_SLOTS - 1: five levels of
// products, then the doubling's three where some lane of the block has
// P == Q (active lanes only).  Warp w < 3 gets coordinate w of this lane's
// sum in r; warp 3 gets nothing.
template <class P, class Q>
__device__ __forceinline__ void add_narrow(const Slots& S, int w, const P& p, const Q& q,
                                           bool active, const ModulusOne& C, uint32_t r[WORDS]) {
  const Modulus& M = C.M;
  // every read up front, so their latencies overlap once: z1 and z2 for
  // all, and x1, x2, y1, y2 for warps 0-3
  uint32_t z1[WORDS], z2[WORDS], e[WORDS], t[WORDS], u[WORDS];
  p.load(2, z1);
  q.load(2, z2);
  if (w == 0) {
    p.load(0, e);
  } else if (w == 1) {
    q.load(0, e);
  } else if (w == 2) {
    p.load(1, e);
  } else {
    q.load(1, e);
  }
  if (w == 0) {
    cc::sqr(z1, M, t);
    S.put(A_Z1Z1, t);
  } else if (w == 1) {
    cc::sqr(z2, M, t);
    S.put(A_Z2Z2, t);
  } else if (w == 2) {
    cc::mul(e, z2, M, t);
    S.put(A_Y1Z2, t);
  } else {
    cc::mul(e, z1, M, t);
    S.put(A_Y2Z1, t);
  }
  __syncthreads();
  if (w == 0) {
    S.get(A_Z2Z2, u);
    cc::mul(e, u, M, t);
    S.put(A_U1, t);  // u1 = x1 z2z2
  } else if (w == 1) {
    S.get(A_Z1Z1, u);
    cc::mul(e, u, M, t);
    S.put(A_U2, t);  // u2 = x2 z1z1
  } else if (w == 2) {
    S.get(A_Y1Z2, t);
    S.get(A_Z2Z2, u);
    cc::mul(t, u, M, t);
    S.put(A_S1, t);  // s1 = y1 z2 z2z2
  } else {
    S.get(A_Y2Z1, t);
    S.get(A_Z1Z1, u);
    cc::mul(t, u, M, t);
    S.put(A_S2, t);  // s2 = y2 z1 z1z1
  }
  __syncthreads();
  uint32_t h[WORDS], rd[WORDS];
  S.get(A_U2, t);
  S.get(A_U1, u);
  cc::sub(t, u, M, h);
  S.get(A_S2, t);
  S.get(A_S1, u);
  cc::sub(t, u, M, rd);
  uint32_t zz[WORDS];
  if (w == 0) {
    cc::sqr(h, M, t);
    S.put(A_HH, t);
  } else if (w == 1) {
    cc::mul(z1, z2, M, zz);  // kept in this warp's registers for z3
  } else if (w == 2) {
    cc::dbl(rd, M, u);
    cc::sqr(u, M, t);
    S.put(A_RR2, t);  // rr^2
  }
  __syncthreads();
  if (w == 0) {
    S.get(A_HH, t);
    cc::dbl(t, M, t);
    cc::dbl(t, M, t);
    cc::mul(h, t, M, t);
    S.put(A_J, t);  // j = h i
  } else if (w == 1) {
    cc::dbl(zz, M, t);
    cc::mul(t, h, M, t);
    S.put(A_Z3, t);  // z3 = 2 z1 z2 h
  } else if (w == 2) {
    S.get(A_HH, t);
    cc::dbl(t, M, t);
    cc::dbl(t, M, t);
    S.get(A_U1, u);
    cc::mul(u, t, M, t);
    S.put(A_V, t);  // v = u1 i
  }
  __syncthreads();
  if (w == 0) {
    uint32_t v[WORDS], rr[WORDS];
    S.get(A_RR2, t);
    S.get(A_J, u);
    cc::sub(t, u, M, t);
    S.get(A_V, v);
    cc::dbl(v, M, u);
    cc::sub(t, u, M, t);  // x3 = rr^2 - j - 2v
    S.put(A_X3, t);
    cc::sub(v, t, M, t);
    cc::dbl(rd, M, rr);
    cc::mul(rr, t, M, t);
    S.put(A_T, t);  // rr (v - x3)
  } else if (w == 2) {
    S.get(A_J, u);
    S.get(A_S1, t);
    cc::mul(t, u, M, t);
    S.put(A_W, t);  // s1 j
  }
  const bool q_inf = is_zero(z2), p_inf = is_zero(z1);
  const bool h_zero = is_zero(h), r_zero = is_zero(rd);
  const bool same = active && !q_inf && !p_inf && h_zero && r_zero;
  if (__syncthreads_or(same)) dbl_narrow(S, A_SLOTS, A_SLOTS + D_X, w, p, M);
  if (w >= 3) return;
  if (q_inf) {  // q at infinity (checked last in the reference): p
    p.load(w, r);
  } else if (p_inf) {  // p at infinity: q
    q.load(w, r);
  } else if (h_zero && r_zero) {  // P == Q
    S.get(A_SLOTS + D_X + w, r);
  } else if (h_zero) {  // P == -Q: infinity (0, 1, 0)
#pragma unroll
    for (int k = 0; k < WORDS; ++k) r[k] = w == 1 ? C.one[k] : 0;
  } else if (w == 0) {
    S.get(A_X3, r);
  } else if (w == 1) {
    S.get(A_T, t);
    S.get(A_W, u);
    cc::dbl(u, M, u);
    cc::sub(t, u, M, r);  // y3 = rr (v - x3) - 2 s1 j
  } else {
    S.get(A_Z3, r);
  }
}

__global__ void __launch_bounds__(NARROW_THREADS)
jac_add_narrow_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                      const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                      uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                      uint32_t* __restrict__ oz, int m, ModulusOne C) {
  __shared__ uint32_t sh[A_SLOTS + D_SLOTS][WORDS][NARROW_LANES];
  const int lane = threadIdx.x % NARROW_LANES, w = threadIdx.x / NARROW_LANES;
  const size_t idx = static_cast<size_t>(blockIdx.x) * NARROW_LANES + lane;
  const bool active = idx < static_cast<size_t>(m);
  const size_t i = active ? idx : static_cast<size_t>(m) - 1;  // where to read
  const size_t ld = static_cast<size_t>(m);
  uint32_t r[WORDS];
  add_narrow(Slots{sh, lane}, w, GlobalPoint{{px, py, pz}, ld, i}, GlobalPoint{{qx, qy, qz}, ld, i},
             active, C, r);
  uint32_t* out[3] = {ox, oy, oz};
  if (active && w < 3) store_elem(out[w], ld, idx, r);
}

// ---------------------------------------------------------------- Horner
// jac_horner: sum_i 2^(c i) w_i of a lane's window sums w_0 .. w_{W-1}, from
// the top window down: c doublings, then the complete add.
//
// Replaces halo2_tpu/ec/device.py:597-607, the reference's jax.lax.fori_loop
// Horner inside _msm_raw (the sharded MSM's combine), which XLA compiles
// into one device loop.  Same formulas as jac_double (dbl-2009-l) and
// jac_add (add-2007-bl with its exceptions, P == Q doubled), every value
// canonical, so the output equals the plain loop (ec/cuda_jac.py:
// horner_plain) limb for limb, infinities' y included (every lane runs
// every doubling, as the plain loop does).
//
// What bounds it: at the sharded MSM's widths (1 to ~64 lanes, a warp or
// a few on 132 SMs) the chain of dependent products, at most W (3c + 5) a
// lane (928 at c = 8, W = 32); the throughput bound (IMADs and the window
// sums' bytes, chip_smoke.py: _horner_work) is below a microsecond.  So
// the design cuts what one chained product costs:
// - a group of GROUP = 4 threads of one warp a lane (jac.cuh).  At each level
//   of a formula every thread of the group runs the same product on the
//   operands its rank in the group picks (selects, not branches, so the
//   warp never diverges), and the group trades the results by
//   __shfl_sync: a doubling's chain is 3 products, an add's 5, as on four
//   warps, with no __syncthreads and no shared memory;
// - the accumulator and the window in registers for the whole ladder (each
//   thread holds the lane's point; the window is loaded at the top of its
//   doublings, so the load overlaps them), no local-memory frame;
// - the product is cc::mul.  A radix-2^26 product whose carries never
//   chain measured slower in one thread (PERF.md): a chained product in
//   one warp costs about its instruction count (320 SASS instructions, 120
//   IMAD.WIDE, here; 608 and 200 there), not the carry chain's latency.
// A block is one warp (8 lanes), so B lanes take ceil(B / 8) SMs.  The
// P == Q doubling inside the add runs when some lane of the warp needs it
// (__any_sync), every thread of the warp through the same shuffles.
constexpr int HORNER_THREADS = 32;
constexpr int HORNER_LANES = HORNER_THREADS / GROUP;

__global__ void __launch_bounds__(HORNER_THREADS)
jac_horner_kernel(const uint32_t* __restrict__ wsum, uint32_t* __restrict__ out, int m, int windows,
                  int c, ModulusOne K) {
  const int g = threadIdx.x % GROUP;
  const size_t b = static_cast<size_t>(blockIdx.x) * HORNER_LANES + threadIdx.x / GROUP;
  const bool active = b < static_cast<size_t>(m);
  // the window sums are (3, 16, m, W): limb j of coordinate k of lane b's
  // window i at ((k * 16 + j) * m + b) * W + i
  const size_t ld = static_cast<size_t>(m) * windows;
  uint32_t x[WORDS], y[WORDS], z[WORDS];  // the accumulator, from infinity (0, 1, 0)
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    x[k] = 0;
    y[k] = K.one[k];
    z[k] = 0;
  }
  for (int i = windows - 1; i >= 0; --i) {
    uint32_t wx[WORDS] = {}, wy[WORDS] = {}, wz[WORDS] = {};  // lanes past m: infinity
    if (active) {
      load_elem(wsum, ld, b * windows + i, wx);
      load_elem(wsum + 16 * ld, ld, b * windows + i, wy);
      load_elem(wsum + 32 * ld, ld, b * windows + i, wz);
    }
    for (int d = 0; d < c; ++d) dbl_group(g, x, y, z, K);
    add_group(g, x, y, z, wx, wy, wz, K);
  }
  if (active && g < 3) {
    uint32_t r[WORDS];
    pick(g, x, y, z, z, r);
    store_elem(out + static_cast<size_t>(g) * 16 * m, m, b, r);
  }
}

}  // namespace

// variant 0: wide (one thread per lane), 1: narrow (four warps per 32 lanes).
extern "C" int h2t_jac_madd(const void* px, const void* py, const void* pz, const void* qx,
                            const void* qy, const void* valid, void* ox, void* oy, void* oz,
                            int m, const void* consts, int variant, void* stream) {
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const auto s = static_cast<cudaStream_t>(stream);
  auto k = variant ? jac_madd_narrow_kernel : jac_madd_wide_kernel;
  const int lanes = variant ? NARROW_LANES : WIDE_THREADS;
  const int threads = variant ? NARROW_THREADS : WIDE_THREADS;
  k<<<(m + lanes - 1) / lanes, threads, 0, s>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<const int*>(valid),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), m, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int h2t_jac_add(const void* px, const void* py, const void* pz, const void* qx,
                           const void* qy, const void* qz, void* ox, void* oy, void* oz, int m,
                           const void* consts, int variant, void* stream) {
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const auto s = static_cast<cudaStream_t>(stream);
  auto k = variant ? jac_add_narrow_kernel : jac_add_wide_kernel;
  const int lanes = variant ? NARROW_LANES : WIDE_THREADS;
  const int threads = variant ? NARROW_THREADS : WIDE_THREADS;
  k<<<(m + lanes - 1) / lanes, threads, 0, s>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<const uint32_t*>(qz),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), m, C);
  return static_cast<int>(cudaGetLastError());
}

// The Horner combine of m lanes' W window sums, (3, 16, m, W) -> (3, 16, m);
// c doublings a window.
extern "C" int h2t_jac_horner(const void* wsum, void* out, int m, int windows, int c,
                              const void* consts, void* stream) {
  if (m <= 0 || windows < 0 || c < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  jac_horner_kernel<<<(m + HORNER_LANES - 1) / HORNER_LANES, HORNER_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wsum), static_cast<uint32_t*>(out), m, windows, c, C);
  return static_cast<int>(cudaGetLastError());
}

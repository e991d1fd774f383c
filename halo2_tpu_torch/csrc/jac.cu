// BN254 G1 group law in Jacobian coordinates, one thread per lane: the mixed
// add of a Jacobian point and an affine point (jac_madd) and the complete
// Jacobian add (jac_add).
//
// Replace halo2_tpu/ec/pallas_jac.py:_madd_kernel and :_add_kernel.  They
// compute the group law of those TPU kernels (same infinity handling, same
// `valid` mask, same P == Q flag), but from the reference's canonical
// formulas, halo2_tpu/ec/device.py:_jac_madd_jnp (madd-2007-bl) and
// :_jac_add_jnp (add-2007-bl): every field value stays canonical (< p), so
// the output equals the plain version (ec/cuda_jac.py) limb for limb.  The
// TPU kernels' lambda = 1/2 scaled output and lazy < 2p bounds are not
// carried over.  As there, the doubling for P == Q lanes is not in the
// kernel: the lane's `same` flag is set and the wrapper applies jac_double.
//
// Points are (16, m) int32 limb arrays per coordinate over BN254 Fq,
// Montgomery form, limb-major (field.cuh); z == 0 marks infinity.
//
// What bounds them: integer multiplies.  A lane takes 11 (madd) or 16 (add)
// Montgomery products of about 136 32-bit multiply-adds each (each a pair
// of IMADs for the 64-bit product), against 520 bytes (madd: 5 coordinates
// of 64 bytes and a flag in, 3 and a flag out) or 580 bytes (add) of memory
// traffic: about 0.4 ns of the H100's integer units (132 SMs x 64 lanes at
// ~1.7 GHz) against 0.16 ns of its published 3.35 TB/s per lane.  This design keeps every intermediate in registers;
// inputs needed only by an exception lane are read again from memory there.
// nvcc -Xptxas -v (CUDA 12.9, sm_90a): jac_madd_kernel 102 registers,
// jac_add_kernel 136 registers, no spills, no stack frame.

#include "field.cuh"

using namespace h2t;

namespace {

// The modulus of Fq and its Montgomery one (R mod p), passed by value.
struct CurveConsts {
  Modulus M;
  uint32_t one[WORDS];
};

// Host side: the 17-word array the Python wrapper passes (p words, n0, one).
CurveConsts consts_from_host(const uint32_t* words) {
  CurveConsts c;
  c.M = modulus_from_host(words);
  for (int k = 0; k < WORDS; ++k) c.one[k] = words[WORDS + 1 + k];
  return c;
}

__device__ __forceinline__ void mod_dbl(const uint32_t a[WORDS], const Modulus& M,
                                        uint32_t r[WORDS]) {
  mod_add(a, a, M, r);
}

// Copy lane idx of a (16, m) coordinate to the output unchanged.
__device__ __forceinline__ void copy_elem(const uint32_t* __restrict__ src,
                                          uint32_t* __restrict__ dst, size_t ld, size_t idx) {
#pragma unroll
  for (int j = 0; j < 2 * WORDS; ++j) dst[j * ld + idx] = src[j * ld + idx];
}

__device__ __forceinline__ void store_one(uint32_t* __restrict__ dst, size_t ld, size_t idx,
                                          const CurveConsts& C) {
  store_elem(dst, ld, idx, C.one);
}

// x3 = rr^2 - j - 2v and y3 = rr (v - x3) - 2 w j, the tail both adds share
// (w is y1 for the mixed add, s1 for the full add).
__device__ __forceinline__ void add_tail(const uint32_t rr[WORDS], const uint32_t j[WORDS],
                                         const uint32_t v[WORDS], const uint32_t w[WORDS],
                                         const Modulus& M, uint32_t x3[WORDS],
                                         uint32_t y3[WORDS]) {
  uint32_t t[WORDS], u[WORDS];
  mont_sqr(rr, M, t);
  mod_sub(t, j, M, t);
  mod_dbl(v, M, u);
  mod_sub(t, u, M, x3);
  mod_sub(v, x3, M, t);
  mont_mul(rr, t, M, t);
  mont_mul(w, j, M, u);
  mod_dbl(u, M, u);
  mod_sub(t, u, M, y3);
}

}  // namespace

// out = p + (qx, qy) where valid, else p; same = valid & P == Q & P finite.
// madd-2007-bl: 7 multiplies and 4 squares.
__global__ void jac_madd_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                                const uint32_t* __restrict__ qy, const int* __restrict__ valid,
                                uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                uint32_t* __restrict__ oz, int* __restrict__ same, int m,
                                CurveConsts C) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  const Modulus& M = C.M;
  same[idx] = 0;
  if (!valid[idx]) {  // masked lane: p unchanged
    copy_elem(px, ox, m, idx);
    copy_elem(py, oy, m, idx);
    copy_elem(pz, oz, m, idx);
    return;
  }
  uint32_t z1[WORDS];
  load_elem(pz, m, idx, z1);
  if (is_zero(z1)) {  // p at infinity: the result is (qx, qy, 1)
    copy_elem(qx, ox, m, idx);
    copy_elem(qy, oy, m, idx);
    store_one(oz, m, idx, C);
    return;
  }
  uint32_t z1z1[WORDS], h[WORDS], hh[WORDS], i4[WORDS], j[WORDS], rr[WORDS], v[WORDS];
  uint32_t t[WORDS], u[WORDS];
  mont_sqr(z1, M, z1z1);
  load_elem(qx, m, idx, t);
  mont_mul(t, z1z1, M, u);  // u2
  load_elem(px, m, idx, t);  // x1
  mod_sub(u, t, M, h);
  mont_sqr(h, M, hh);
  mod_dbl(hh, M, i4);
  mod_dbl(i4, M, i4);
  mont_mul(h, i4, M, j);
  mont_mul(t, i4, M, v);  // x1 * i
  mont_mul(z1, z1z1, M, t);
  load_elem(qy, m, idx, u);
  mont_mul(u, t, M, u);  // s2
  uint32_t y1[WORDS];
  load_elem(py, m, idx, y1);
  mod_sub(u, y1, M, t);
  mod_dbl(t, M, rr);
  uint32_t x3[WORDS], y3[WORDS];
  add_tail(rr, j, v, y1, M, x3, y3);
  mod_add(z1, h, M, t);  // z3 = (z1 + h)^2 - z1z1 - hh
  mont_sqr(t, M, t);
  mod_sub(t, z1z1, M, t);
  mod_sub(t, hh, M, u);
  store_elem(ox, m, idx, x3);
  store_elem(oy, m, idx, y3);
  store_elem(oz, m, idx, u);
  same[idx] = is_zero(h) && is_zero(rr);
}

// out = p + q, complete: p or q at infinity returns the other, P == -Q gives
// infinity (0, 1, 0), P == Q sets same.  add-2007-bl: 12 multiplies and 4
// squares.
__global__ void jac_add_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                               const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                               const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                               uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, int* __restrict__ same, int m,
                               CurveConsts C) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  const Modulus& M = C.M;
  same[idx] = 0;
  uint32_t z1[WORDS], z2[WORDS];
  load_elem(pz, m, idx, z1);
  load_elem(qz, m, idx, z2);
  if (is_zero(z2)) {  // q at infinity (checked last in the reference): p
    copy_elem(px, ox, m, idx);
    copy_elem(py, oy, m, idx);
    copy_elem(pz, oz, m, idx);
    return;
  }
  if (is_zero(z1)) {  // p at infinity: q
    copy_elem(qx, ox, m, idx);
    copy_elem(qy, oy, m, idx);
    copy_elem(qz, oz, m, idx);
    return;
  }
  uint32_t z1z1[WORDS], z2z2[WORDS], s1[WORDS], zz[WORDS], t[WORDS], u[WORDS];
  mont_sqr(z1, M, z1z1);
  mont_sqr(z2, M, z2z2);
  load_elem(py, m, idx, t);
  mont_mul(t, z2, M, t);
  mont_mul(t, z2z2, M, s1);  // s1 = y1 z2 z2z2
  load_elem(qy, m, idx, t);
  mont_mul(t, z1, M, t);
  mont_mul(t, z1z1, M, u);  // s2 = y2 z1 z1z1
  uint32_t r[WORDS];
  mod_sub(u, s1, M, r);
  mont_mul(z1, z2, M, zz);
  uint32_t u1[WORDS], h[WORDS];
  load_elem(px, m, idx, t);
  mont_mul(t, z2z2, M, u1);
  load_elem(qx, m, idx, t);
  mont_mul(t, z1z1, M, u);  // u2
  mod_sub(u, u1, M, h);
  const bool h_zero = is_zero(h), r_zero = is_zero(r);
  if (h_zero && !r_zero) {  // P == -Q: infinity
    const uint32_t zero[WORDS] = {0, 0, 0, 0, 0, 0, 0, 0};
    store_elem(ox, m, idx, zero);
    store_one(oy, m, idx, C);
    store_elem(oz, m, idx, zero);
    return;
  }
  uint32_t i4[WORDS], j[WORDS], v[WORDS], rr[WORDS];
  mont_sqr(h, M, t);  // hh
  mod_dbl(t, M, i4);
  mod_dbl(i4, M, i4);
  mont_mul(h, i4, M, j);
  mod_dbl(r, M, rr);
  mont_mul(u1, i4, M, v);
  uint32_t x3[WORDS], y3[WORDS];
  add_tail(rr, j, v, s1, M, x3, y3);
  mod_dbl(zz, M, t);  // z3 = 2 z1 z2 h
  mont_mul(t, h, M, u);
  store_elem(ox, m, idx, x3);
  store_elem(oy, m, idx, y3);
  store_elem(oz, m, idx, u);
  same[idx] = h_zero && r_zero;
}

extern "C" int h2t_jac_madd(const void* px, const void* py, const void* pz, const void* qx,
                            const void* qy, const void* valid, void* ox, void* oy, void* oz,
                            void* same, int m, const void* consts, void* stream) {
  const CurveConsts C = consts_from_host(static_cast<const uint32_t*>(consts));
  const int threads = 128;
  const int blocks = (m + threads - 1) / threads;
  jac_madd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<const int*>(valid),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<int*>(same), m, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int h2t_jac_add(const void* px, const void* py, const void* pz, const void* qx,
                           const void* qy, const void* qz, void* ox, void* oy, void* oz,
                           void* same, int m, const void* consts, void* stream) {
  const CurveConsts C = consts_from_host(static_cast<const uint32_t*>(consts));
  const int threads = 128;
  const int blocks = (m + threads - 1) / threads;
  jac_add_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<const uint32_t*>(qz),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<int*>(same), m, C);
  return static_cast<int>(cudaGetLastError());
}

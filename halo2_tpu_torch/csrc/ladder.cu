// jac_ladder: a batched double-and-add in one launch (ec.device's
// scalar_mul_batched, per-lane bases; since jac_fixed_base, below, took
// over ParamsKZG.setup, no path launches it).  Lane i of m holds a point P_i and the bits of its scalar,
// LSB first in rows r = 0 .. nbits - 1 of a (nbits, m) uint8 array (nonzero
// = set); acc starts at infinity, and in row r acc = acc + base where the
// bit is set (the complete add), then base = 2 base (dbl-2009-l) except
// after the last row.  Out: acc, (3, 16, m) x, y, z.
//
// Replaces the reference's lax.scan scalar_mul_batched
// (halo2_tpu/ec/device.py:246), which halo2_tpu/kzg/params.py:74 compiles
// into one device program with tuned_jit; the port ran it as 256 rounds of a
// jac_add launch, three selects and ~21 field-op launches (mont_sqr,
// mod_add, mod_sub at 2^16 lanes for k = 16).  The formulas are jac.cuh's
// jac_dbl_into and jac_add_into, the same field values as
// ec/device.py:jac_double and the plain complete add, every value
// canonical, so the output equals scalar_mul_batched_plain (ec/cuda_jac.py)
// limb for limb.
//
// What bounds it: integer multiplies.  A doubling is 2 products and 5
// squares (1,624 IMADs), an add 12 products and 4 squares (4,128), against
// 96 bytes of point and nbits bytes of bits a lane; the setup's 2^16 lanes
// take ~6.1e10 IMADs, ~3.7 ms at the H100's IMAD rate.  The design: a
// thread a lane, both points in registers for the whole ladder (the port's
// field-op chain sent every intermediate through device memory), at three
// 128-thread blocks an SM (at most 168 registers); a row whose bit no lane
// of the warp has set skips the add (a branch no thread takes), which
// covers the top rows of scalars below 2^254.
//
// What holds it at 2^16 lanes below the bound (PERF.md): a warp runs the
// add for all its lanes when any has the bit, in ~254 of the 256 rows,
// 1.69x the products the lanes' set bits need, and each warp's time is its
// own chain of a doubling and an add a row.  Two designs that cut the adds
// issued measured no faster on one H100 (scripts/ladder_variants.cu,
// timed by scripts/ladder_probe.py): a ring of each lane's pending bases in
// shared memory, an add step only when every lane of the warp has one
// queued, and the block's set bits of a row compacted onto ceil(bits / 32)
// warps through shared memory; neither shortens the busiest warp's chain.

#include "jac.cuh"

using namespace h2t;

namespace {

constexpr int LADDER_THREADS = 128;
constexpr int LADDER_MIN_BLOCKS = 3;

__device__ __forceinline__ void set_infinity(Jac& p, const ModulusOne& K) {  // (0, 1, 0)
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    p.c[0][k] = 0;
    p.c[1][k] = K.one[k];
    p.c[2][k] = 0;
  }
}

__global__ void __launch_bounds__(LADDER_THREADS, LADDER_MIN_BLOCKS)
jac_ladder_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  const uint32_t* __restrict__ pz, const uint8_t* __restrict__ bits,
                  uint32_t* __restrict__ out, int m, int nbits, ModulusOne K) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  const size_t ld = static_cast<size_t>(m);
  Jac acc, base;
  set_infinity(acc, K);
  load_elem(px, ld, i, base.c[0]);
  load_elem(py, ld, i, base.c[1]);
  load_elem(pz, ld, i, base.c[2]);
  for (int r = 0; r < nbits; ++r) {
    if (bits[static_cast<size_t>(r) * ld + i]) jac_add_into(RegPoint{&acc}, RegPoint{&base}, K, RegOut{&acc});
    if (r + 1 < nbits) jac_dbl_into(base.c[0], base.c[1], base.c[2], K.M, RegOut{&base});
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) store_elem(out + static_cast<size_t>(k) * 16 * ld, ld, i, acc.c[k]);
}

}  // namespace

// m lanes' (16, m) x, y, z and their (nbits, m) uint8 bit rows -> (3, 16, m).
extern "C" int h2t_jac_ladder(const void* px, const void* py, const void* pz, const void* bits, void* out, int m,
                              int nbits, const void* consts, void* stream) {
  if (m <= 0 || nbits < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne K = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  jac_ladder_kernel<<<(m + LADDER_THREADS - 1) / LADDER_THREADS, LADDER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py), static_cast<const uint32_t*>(pz),
      static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(out), m, nbits, K);
  return static_cast<int>(cudaGetLastError());
}

// jac_fixed_base: [s_i] P for one affine point P that every lane shares
// (ec.device.fixed_base_mul; ParamsKZG.setup's G tau^i), in one launch, a
// thread a lane, from a table of P's window multiples: entry (j, d) =
// d 2^(w j) P for window j < ceil(256 / w) and digit d = 1 .. 2^w - 1, at
// row j (2^w - 1) + d - 1, as affine Montgomery x then y, 8 words each (64
// bytes; built on the host once per point and window width,
// ec/cuda_jac.py: fixed_base_table).  Lane i's scalar is column i of an
// (8, m) array of little-endian 32-bit words.  acc starts at infinity; for
// j = 0, 1, ..: the next w bits of the scalar are the digit d, and where
// d != 0, acc = acc + entry (j, d) by jac.cuh's complete mixed add
// (jac_madd_into: acc at infinity takes the entry, P == Q doubles, P == -Q
// gives z = 0).  Out: acc, (3, 16, m).  Equal limb for limb to
// fixed_base_mul_plain (ec/cuda_jac.py), the same windows on the plain
// mixed add.
//
// Replaces, for the setup, the reference's lax.scan scalar_mul_batched
// (halo2_tpu/ec/device.py:246, compiled by halo2_tpu/kzg/params.py:74)
// and the port's jac_ladder: the 255 doublings a lane are gone (the table
// holds them), and every lane runs the same window loop, so a warp adds in
// each window where any lane's digit is nonzero (all but 1 in 2^(32 w)),
// not in every row where any lane's bit is set.  What bounds it: 2,768
// IMADs a mixed add, ceil(256 / w) of them a lane: at w = 6 and 2^16 lanes
// ~0.44 ms at the H100's IMAD rate, against ~3.7 ms of doublings and adds
// for the ladder.  The window width is 6 (43 windows, a 173,376-byte table),
// the table read through __ldg (the lanes' gathers served from L1/L2), at
// three 128-thread blocks an SM (136 registers, no spill): on one H100,
// w = 6 took 0.60-0.62 ms at 2^16 lanes where w = 5 took 0.71-0.72 and
// w = 4 0.90; one bulk copy of the table into shared memory a block (w =
// 4, 5) was no faster at 2^16 and 1.5x slower at 2^13-2^14; four blocks an
// SM (128 registers, a 24-byte spill) was within 3 % at 2^13-2^16, the IMAD
// pipe as busy with 12 warps an SM as with 16 (scripts/table_variants.cu
// holds the variants, scripts/table_probe.py times them; PERF.md).  The
// wrapper passes its w, and another is refused.

namespace {

constexpr int FB_W = 6;
constexpr int FB_DIGITS = (1 << FB_W) - 1;
constexpr int FB_WINDOWS = (256 + FB_W - 1) / FB_W;
// three 128-thread blocks an SM (at most 168 registers)
constexpr int FB_THREADS = 128;
constexpr int FB_MIN_BLOCKS = 3;

__device__ __forceinline__ void load_entry(const uint4* __restrict__ tab, int e, uint32_t x[WORDS],
                                           uint32_t y[WORDS]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint4 v = __ldg(tab + 4 * e + h);
    uint32_t* dst = h < 2 ? x + 4 * h : y + 4 * (h - 2);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

__global__ void __launch_bounds__(FB_THREADS, FB_MIN_BLOCKS)
jac_fixed_base_kernel(const uint32_t* __restrict__ scalars, const uint4* __restrict__ table,
                      uint32_t* __restrict__ out, int m, ModulusOne K) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  const size_t ld = static_cast<size_t>(m);
  uint32_t s[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) s[k] = scalars[k * ld + i];
  Jac acc;
  set_infinity(acc, K);
#pragma unroll 1
  for (int j = 0; j < FB_WINDOWS; ++j) {
    const uint32_t d = s[0] & FB_DIGITS;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) s[k] = (s[k] >> FB_W) | (k + 1 < WORDS ? s[k + 1] << (32 - FB_W) : 0u);
    if (d == 0) continue;
    uint32_t qx[WORDS], qy[WORDS];
    load_entry(table, j * FB_DIGITS + static_cast<int>(d) - 1, qx, qy);
    jac_madd_into(RegPoint{&acc}, qx, qy, K, RegOut{&acc});
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) store_elem(out + static_cast<size_t>(k) * 16 * ld, ld, i, acc.c[k]);
}

}  // namespace

// m lanes' (8, m) scalar words, the (FB_WINDOWS (2^w - 1), 16) table ->
// (3, 16, m); window must be the compiled w.
extern "C" int h2t_jac_fixed_base(const void* scalars, const void* table, void* out, int m, int window,
                                  const void* consts, void* stream) {
  if (m <= 0 || window != FB_W) return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne K = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  jac_fixed_base_kernel<<<(m + FB_THREADS - 1) / FB_THREADS, FB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(scalars), static_cast<const uint4*>(table), static_cast<uint32_t*>(out), m, K);
  return static_cast<int>(cudaGetLastError());
}

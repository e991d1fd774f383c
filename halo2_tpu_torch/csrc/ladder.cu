// jac_ladder: the batched double-and-add of ParamsKZG.setup's device branch
// in one launch.  Lane i of m holds a point P_i and the bits of its scalar,
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

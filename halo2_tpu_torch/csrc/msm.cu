// The device MSM's window-sum rounds (ec/device.py:_window_sums) over a
// batch of R = B x W rows (B scalar sets over the same points, W windows
// each) in a fixed number of launches:
//
// - msm_chunk_acc: the intra-chunk suffix rounds.  Lane (row, chunk) starts
//   at infinity and runs its chunk's q rounds in registers, from the last
//   sorted entry down: gather the point the entry names, negate its y where
//   the entry's signed digit is negative (p - y, 0 kept as 0, as
//   DeviceField.neg does), the mixed add (jac.cuh, P == Q doubled), and
//   store the running sum.  Replaces the reference's fori_loop at
//   halo2_tpu/ec/device.py:465, which the port ran as q rounds of a gather,
//   a mod_sub, a select, a jac_madd and three strided slice writes.  The
//   entries and the running sums are position-major, (R, q, C): a warp's
//   lanes are neighbouring chunks, so each round's entry reads and sum
//   stores are coalesced (chunk-major, every store of a warp touched 32
//   sectors, left half-written in L2 from round to round: 8-14 % of the
//   bound, PERF.md); the points come as one (n, 32) table, a point's 128
//   bytes in eight 16-byte loads.
// - jac_suffix_scan: the exclusive suffix sums of each row's C chunk totals,
//   out[i] = sum_{j > i} in[j], infinity at C - 1.  Replaces the reference's
//   _excl_suffix_scan (halo2_tpu/ec/device.py:359: a sequential fori_loop of
//   complete adds over groups of 64 chunks, recursion on the group totals,
//   one full-width add), which the port ran as one jac_add launch a round.
//   A block scans a tile of up to SCAN_TILE chunks in shared memory in
//   log2(tile) Kogge-Stone steps and writes its tile total; above SCAN_TILE
//   chunks the caller scans the tile totals the same way and adds each
//   tile's suffix to its chunks in one offsets launch (mode 1): 1 launch up
//   to 256 chunks, 3 up to 65,536.  (Brent-Kung's steps, a quarter of the
//   adds in twice the steps, measured 1.7-1.9x slower at every batch an MSM
//   gives the scan, PERF.md: the steps' latency bounds it, not their adds.)
//
// The association order differs from the reference's sequential scan, and
// add-2007-bl is not symmetric in its Jacobian output, so the sums are other
// representatives of the same points: the plain versions (ec/cuda_jac.py)
// run this file's order, and equal the kernels limb for limb.
//
// Points are (16, m) int32 limb arrays per coordinate, three coordinates
// stacked: (3, 16, R, ...) with limb j of coordinate k of element e at
// ((k * 16 + j) * ld + e); Montgomery form over BN254 Fq; z == 0 marks
// infinity.
//
// What bounds them: msm_chunk_acc the IMADs of its R C (q - 1) mixed adds
// (a lane's chain is q dependent adds; the gathers are random: the entries
// are sorted by digit); jac_suffix_scan, at the batches a
// prove gives it, the latency of its steps: each is one complete add (16
// products) that every active lane of a tile runs at once, log2(tile)
// steps deep.

#include "jac.cuh"

using namespace h2t;

namespace {

constexpr int ACC_THREADS = 128;
constexpr int SCAN_TILE = 256;  // the most chunks (threads) a scan block takes
constexpr int OFFSET_THREADS = 128;

// x and y of point i of a (n, 32) table (x's 16 limbs, then y's).
__device__ __forceinline__ void load_point(const uint32_t* __restrict__ pts, size_t i, uint32_t x[WORDS],
                                           uint32_t y[WORDS]) {
  const uint4* p = reinterpret_cast<const uint4*>(pts + 32 * i);
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const uint4 a = __ldg(p + v);
    uint32_t* w = v < 4 ? x + 2 * v : y + 2 * (v - 4);
    w[0] = a.x | (a.y << 16);
    w[1] = a.z | (a.w << 16);
  }
}

__global__ void __launch_bounds__(ACC_THREADS)
msm_chunk_acc_kernel(const uint32_t* __restrict__ pts, const int* __restrict__ order,
                     const uint8_t* __restrict__ sign, uint32_t* __restrict__ sfx, uint32_t* __restrict__ tot,
                     int rows, int chunks, int q, ModulusOne C) {
  const size_t lane = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t lanes = static_cast<size_t>(rows) * chunks;
  if (lane >= lanes) return;
  // entry pos of lane (row, chunk), and its running sum in sfx (3, 16, R,
  // q C), at (row q + pos) C + chunk
  const size_t row = lane / chunks, chunk = lane % chunks;
  const size_t ld = lanes * q;
  const GlobalOut sfx_out{{sfx, sfx + 16 * ld, sfx + 32 * ld}, ld, 0};
  const uint32_t zero[WORDS] = {};
  Jac acc;
  store_infinity(RegOut{&acc}, C);
  for (int pos = q - 1; pos >= 0; --pos) {
    const size_t e = (row * q + pos) * chunks + chunk;
    uint32_t qx[WORDS], qy[WORDS];
    load_point(pts, static_cast<size_t>(order[e]), qx, qy);
    if (sign[e]) cc::sub(zero, qy, C.M, qy);  // -(x, y) = (x, p - y)
    jac_madd_into(RegPoint{&acc}, qx, qy, C, RegOut{&acc});
    GlobalOut o = sfx_out;
    o.i = e;
#pragma unroll
    for (int k = 0; k < 3; ++k) o.store(k, acc.c[k]);
  }
  const GlobalOut t{{tot, tot + 16 * lanes, tot + 32 * lanes}, lanes, lane};
#pragma unroll
  for (int k = 0; k < 3; ++k) t.store(k, acc.c[k]);
}

// A tile's points in shared memory: word j of coordinate k of slot s at
// sh[k][j][s], so a warp's lanes read consecutive banks.
__device__ __forceinline__ void put(uint32_t (*sh)[WORDS][SCAN_TILE], int s, const Jac& x) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < WORDS; ++j) sh[k][j][s] = x.c[k][j];
}

__device__ __forceinline__ void get(uint32_t (*sh)[WORDS][SCAN_TILE], int s, Jac& x) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < WORDS; ++j) x.c[k][j] = sh[k][j][s];
}

// One block scans tile g of row r: the exclusive suffix sums of the tile's
// chunks (chunks past C are infinity) into out, its total into tot[r, g]
// when tot is given.  blockDim.x == T, a power of two <= SCAN_TILE.  Step
// d = 1, 2, .. T / 2 of the inclusive suffix scan: every slot i with a
// partner takes x[i] = x[i] + x[i + d], every read of a step before its
// writes.
__global__ void __launch_bounds__(SCAN_TILE)
jac_suffix_scan_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                       uint32_t* __restrict__ tot, int rows, int chunks, ModulusOne K) {
  __shared__ uint32_t sh[3][WORDS][SCAN_TILE];
  const int T = blockDim.x, i = threadIdx.x;
  const int tiles = (chunks + T - 1) / T;
  const size_t row = blockIdx.x / tiles;
  const int g = blockIdx.x % tiles;
  const int chunk = g * T + i;
  const size_t ld = static_cast<size_t>(rows) * chunks;
  const size_t e = row * chunks + chunk;
  Jac x;
  if (chunk < chunks) {
    const GlobalPoint src{{in, in + 16 * ld, in + 32 * ld}, ld, e};
#pragma unroll
    for (int k = 0; k < 3; ++k) src.load(k, x.c[k]);
  } else {
    store_infinity(RegOut{&x}, K);
  }
  put(sh, i, x);
  __syncthreads();
  for (int d = 1; d < T; d *= 2) {
    const bool active = i + d < T;
    Jac y;
    if (active) get(sh, i + d, y);
    __syncthreads();
    if (active) {
      jac_add_into(RegPoint{&x}, RegPoint{&y}, K, RegOut{&x});
      put(sh, i, x);
    }
    __syncthreads();
  }
  if (chunk < chunks) {
    Jac o;
    if (i + 1 < T) {
      get(sh, i + 1, o);
    } else {
      store_infinity(RegOut{&o}, K);
    }
    const GlobalOut dst{{out, out + 16 * ld, out + 32 * ld}, ld, e};
#pragma unroll
    for (int k = 0; k < 3; ++k) dst.store(k, o.c[k]);
  }
  if (tot != nullptr && i == 0) {  // slot 0 holds the tile's sum
    const size_t tld = static_cast<size_t>(rows) * tiles;
    const GlobalOut dst{{tot, tot + 16 * tld, tot + 32 * tld}, tld, row * tiles + g};
#pragma unroll
    for (int k = 0; k < 3; ++k) dst.store(k, x.c[k]);
  }
}

// out[r, c] = in[r, c] + suffix[r, c / T]: each chunk's in-tile suffix plus
// the sum of the tiles after its own.
__global__ void __launch_bounds__(OFFSET_THREADS)
jac_suffix_scan_offsets_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ suffix,
                               uint32_t* __restrict__ out, int rows, int chunks, int T, ModulusOne K) {
  const size_t lane = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t ld = static_cast<size_t>(rows) * chunks;
  if (lane >= ld) return;
  const int tiles = (chunks + T - 1) / T;
  const size_t tld = static_cast<size_t>(rows) * tiles;
  const size_t ti = lane / chunks * tiles + lane % chunks / T;
  jac_add_into(GlobalPoint{{in, in + 16 * ld, in + 32 * ld}, ld, lane},
               GlobalPoint{{suffix, suffix + 16 * tld, suffix + 32 * tld}, tld, ti}, K,
               GlobalOut{{out, out + 16 * ld, out + 32 * ld}, ld, lane});
}

}  // namespace

// The intra-chunk rounds of R rows x C chunks of q sorted entries: order and
// sign (R, q, C), position-major (int32 point indices into pts, bytes
// 0/1); pts the (n, 32) point table (16-byte aligned); sfx (3, 16, R, q C)
// the running sums, position-major, tot (3, 16, R, C) the chunk totals.
extern "C" int h2t_msm_chunk_acc(const void* pts, const void* order, const void* sign, void* sfx, void* tot,
                                 int rows, int chunks, int q, const void* consts, void* stream) {
  if (rows <= 0 || chunks <= 0 || q <= 0 || reinterpret_cast<uintptr_t>(pts) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const size_t blocks = (static_cast<size_t>(rows) * chunks + ACC_THREADS - 1) / ACC_THREADS;
  if (blocks > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
  msm_chunk_acc_kernel<<<static_cast<unsigned>(blocks), ACC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const int*>(order), static_cast<const uint8_t*>(sign),
      static_cast<uint32_t*>(sfx), static_cast<uint32_t*>(tot), rows, chunks, q, C);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the suffix scan over (3, 16, rows, chunks) points in tiles of
// T chunks (a power of two <= 256).  mode 0: the in-tile exclusive suffixes
// into out and, when tot is not null, the tile totals (3, 16, rows,
// ceil(chunks / T)) into tot.  mode 1: out = in plus the tile suffixes given
// in add, (3, 16, rows, ceil(chunks / T)).
extern "C" int h2t_jac_suffix_scan(const void* in, const void* add, void* out, void* tot, int rows,
                                   int chunks, int T, int mode, const void* consts, void* stream) {
  if (rows <= 0 || chunks <= 0 || T <= 0 || T > SCAN_TILE || (T & (T - 1)) || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    const size_t blocks = (static_cast<size_t>(rows) * chunks + OFFSET_THREADS - 1) / OFFSET_THREADS;
    if (blocks > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
    jac_suffix_scan_offsets_kernel<<<static_cast<unsigned>(blocks), OFFSET_THREADS, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(add), static_cast<uint32_t*>(out), rows,
        chunks, T, C);
  } else {
    const size_t blocks = static_cast<size_t>(rows) * ((chunks + T - 1) / T);
    if (blocks > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
    jac_suffix_scan_kernel<<<static_cast<unsigned>(blocks), T, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), static_cast<uint32_t*>(tot), rows, chunks, C);
  }
  return static_cast<int>(cudaGetLastError());
}

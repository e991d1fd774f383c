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
//   one full-width add).  One launch scans tiles of T chunks and writes
//   their totals; above one tile the caller scans the tile totals the same
//   way and adds each tile's suffix to its chunks in one offsets launch: 1
//   launch up to one tile, 3 up to T^2 chunks.
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
// What bounds them.  msm_chunk_acc: the IMADs of its R C (q - 1) mixed adds
// (a lane's chain is q dependent adds; the gathers are random: the entries
// are sorted by digit).  jac_suffix_scan, measured on the H100 (PERF.md):
// one thread's complete add is one serial stream of ~2,800 IMAD.WIDE on
// PTX carry chains (field_cc.cuh), ~8 us, and one warp a scheduler already
// keeps that scheduler's IMAD pipe busy, so a step's time grows with the
// warps that share a scheduler (1 -> 8 us an add, ~5 -> ~30 us).  A
// Kogge-Stone tile of one chunk a thread (the design these two replaced)
// runs log2(T) adds deep and 1,793 adds a 256-chunk row, against the 254
// of a sequential scan.  So the scan has two regimes, and one kernel a
// schedule for each (ec/cuda_jac.py:scan_plan picks one from rows x
// chunks, by thresholds measured on the card):
// - few rows (a scalar set at 2^11 is 32 rows of 256 chunks: 32 blocks of
//   one chunk a thread leave 100 SMs idle, and each step waits out one
//   add): the length of a step.  A chunk runs on a group of four threads
//   (jac.cuh: add_group, five product levels instead of 16 serial
//   products), so a 256-chunk tile needs 1,024 threads: a cluster of up to
//   CLUSTER_MAX blocks of CLUSTER_CHUNKS chunks, which read each other's
//   slots through distributed shared memory, one cluster barrier a step.
//   The blocks are small and capped at 168 registers so that three fit an
//   SM: a cluster's blocks must share one GPC, and at one block of 64
//   chunks an SM the card held fewer clusters of four than a set's 32
//   rows, so one set took two waves.
// - many rows (2-20 sets; the 2^16 and 2^18 windows' 8,192-16,384 chunks):
//   the work, since the tiles fill the card.  A thread sums k consecutive
//   chunks serially, the block runs the steps over the thread sums, and
//   each thread walks its chunks back from its exclusive suffix: ~2 (k -
//   1) / k + log2(T / k) / k adds a chunk (1,025 / 705 a 256-chunk row at
//   k = 2 / 4) in a chain of 2 (k - 1) + log2(T / k) adds.
// (Brent-Kung's steps, a quarter of the adds in twice the steps, measured
// 1.7-1.9x slower than one-chunk Kogge-Stone at every batch, and k = 8,
// 577 adds a row, slower than k = 4 at every batch: PERF.md.)

#include <cooperative_groups.h>

#include "jac.cuh"

namespace cg = cooperative_groups;
using namespace h2t;

namespace {

constexpr int ACC_THREADS = 128;
constexpr int CLUSTER_CHUNKS = 32;  // the chunks a block of the cluster scan holds
constexpr int CLUSTER_THREADS = GROUP * CLUSTER_CHUNKS;
constexpr int CLUSTER_MAX = 8;  // its blocks a cluster: tiles of up to 256 chunks
constexpr int CLUSTER_BLOCKS_SM = 3;  // blocks an SM: 168 registers a thread
constexpr int COARSE_MAX_THREADS = 256;  // the most threads a block of the coarsened scan has
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

// The suffix scan's tiles.  A tile is T chunks of one row (T a power of
// two; chunks past C are infinity) and yields each chunk's exclusive suffix
// inside the tile and, when tot is given, the tile's total.  Both schedules
// end in an inclusive suffix scan of Kogge-Stone steps d = 1, 2, .. over
// slots: slot i takes x[i] + x[i + d] (x[i] first: add-2007-bl is not
// symmetric in its Jacobian output), every read of a step before its
// writes, the slots in two buffers that the steps alternate, one barrier a
// step.  ec/cuda_jac.py:_scan_tiles_plain runs the same order.

// Slot s of a buffer of n slots: word j of coordinate k at [(k WORDS + j)
// n + s], so a warp's lanes read neighbouring banks.
__device__ __forceinline__ void put(uint32_t* buf, int n, int s, const Jac& x) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < WORDS; ++j) buf[(k * WORDS + j) * n + s] = x.c[k][j];
}

__device__ __forceinline__ void get(const uint32_t* buf, int n, int s, Jac& x) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < WORDS; ++j) x.c[k][j] = buf[(k * WORDS + j) * n + s];
}

// Chunk c of a row's (3, 16, R, C) points at element e, infinity past C.
__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ in, size_t ld, size_t e, bool real,
                                           const ModulusOne& K, Jac& x) {
  if (real) {
    const GlobalPoint src{{in, in + 16 * ld, in + 32 * ld}, ld, e};
#pragma unroll
    for (int k = 0; k < 3; ++k) src.load(k, x.c[k]);
  } else {
    store_infinity(RegOut{&x}, K);
  }
}

// Few rows: a tile of up to CLUSTER_CHUNKS * CLUSTER_MAX chunks on a
// cluster of cs = T / per blocks (per = min(T, CLUSTER_CHUNKS) slots a
// block), one chunk a group of four threads, the complete add as add_group's
// five product levels.  A step whose partner slot lies in another block of
// the cluster reads it from that block's shared memory (distributed shared
// memory), and cluster.sync() is the step's barrier.  Groups past per
// (blocks of T < 8 slots fill one warp) hold nothing and only join the
// shuffles.
__global__ void __launch_bounds__(CLUSTER_THREADS, CLUSTER_BLOCKS_SM)
jac_suffix_scan_cluster_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                               uint32_t* __restrict__ tot, int rows, int chunks, int T, ModulusOne K) {
  __shared__ uint32_t sh[2][3][WORDS][CLUSTER_CHUNKS];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = T / cs;
  const int g = threadIdx.x % GROUP, li = threadIdx.x / GROUP;
  const bool held = li < per;
  const int slot = rank * per + li;
  const int tiles = (chunks + T - 1) / T;
  const size_t tile_id = blockIdx.x / cs;
  const size_t row = tile_id / tiles;
  const int chunk = static_cast<int>(tile_id % tiles) * T + slot;
  const size_t ld = static_cast<size_t>(rows) * chunks;
  const size_t e = row * chunks + chunk;
  const bool real = held && chunk < chunks;
  Jac x;
  load_chunk(in, ld, e, real, K, x);
  // slot s of buffer b, in whichever block of the cluster holds it
  auto slot_src = [&](int b, int s) -> const uint32_t* {
    const uint32_t* base = &sh[b][0][0][0];
    const int r = s / per;
    return (r == rank ? base : cluster.map_shared_rank(base, r)) + s % per;
  };
  auto put_coord = [&](int b) {  // thread g < 3 of the group writes coordinate g
    if (held && g < 3) {
      uint32_t v[WORDS];
      pick(g, x.c[0], x.c[1], x.c[2], x.c[2], v);
#pragma unroll
      for (int j = 0; j < WORDS; ++j) sh[b][g][j][li] = v[j];
    }
  };
  put_coord(0);
  cluster.sync();
  int b = 0;
  for (int d = 1; d < T; d *= 2) {
    Jac y;
    if (held && slot + d < T) {
      const uint32_t* p = slot_src(b, slot + d);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < WORDS; ++j) y.c[k][j] = p[(k * WORDS + j) * CLUSTER_CHUNKS];
    } else {
      store_infinity(RegOut{&y}, K);  // q at infinity: add_group keeps x
    }
    add_group(g, x.c[0], x.c[1], x.c[2], y.c[0], y.c[1], y.c[2], K);
    b ^= 1;
    put_coord(b);
    cluster.sync();
  }
  if (real && g < 3) {  // the exclusive suffix: slot + 1's inclusive one, infinity at the tile's end
    uint32_t v[WORDS];
    if (slot + 1 < T) {
      const uint32_t* p = slot_src(b, slot + 1);
#pragma unroll
      for (int j = 0; j < WORDS; ++j) v[j] = p[(g * WORDS + j) * CLUSTER_CHUNKS];
    } else {
#pragma unroll
      for (int j = 0; j < WORDS; ++j) v[j] = g == 1 ? K.one[j] : 0;
    }
    store_elem(out + static_cast<size_t>(g) * 16 * ld, ld, e, v);
  }
  if (tot != nullptr && slot == 0 && g < 3) {  // slot 0 holds the tile's sum
    const size_t tld = static_cast<size_t>(rows) * tiles;
    uint32_t v[WORDS];
    pick(g, x.c[0], x.c[1], x.c[2], x.c[2], v);
    store_elem(tot + static_cast<size_t>(g) * 16 * tld, tld, tile_id, v);
  }
  cluster.sync();  // no block leaves while another may read its shared memory
}

// Many rows: a tile of T = t k chunks on a block of t threads, k
// consecutive chunks a thread, one thread a complete add (jac_add_into).
// Thread i sums its chunks from the last down, acc = c_j + acc (k - 1
// adds); the block runs the Kogge-Stone steps over the t sums; then the
// thread walks its chunks back from its exclusive suffix s (slot i + 1's
// inclusive one): chunk k - 1 takes s, and chunk j - 1 takes s = c_j + s
// (k - 1 adds).  k = 1 is plain Kogge-Stone over one chunk a thread, the
// fastest where a few rows of up to 128 chunks leave the card half idle.
__global__ void __launch_bounds__(COARSE_MAX_THREADS)
jac_suffix_scan_coarse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                              uint32_t* __restrict__ tot, int rows, int chunks, int T, int k, ModulusOne K) {
  extern __shared__ uint32_t sh[];  // two buffers of t slots
  const int t = T / k, i = threadIdx.x;
  const int words = 3 * WORDS * t;
  const int tiles = (chunks + T - 1) / T;
  const size_t row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int c0 = tile * T + i * k;  // this thread's first chunk
  const size_t ld = static_cast<size_t>(rows) * chunks;
  const size_t e0 = row * chunks + c0;
  Jac acc, c;
  load_chunk(in, ld, e0 + k - 1, c0 + k - 1 < chunks, K, acc);
  for (int j = k - 2; j >= 0; --j) {
    load_chunk(in, ld, e0 + j, c0 + j < chunks, K, c);
    jac_add_into(RegPoint{&c}, RegPoint{&acc}, K, RegOut{&acc});
  }
  put(sh, t, i, acc);
  __syncthreads();
  int b = 0;
  for (int d = 1; d < t; d *= 2) {
    if (i + d < t) {
      Jac y;
      get(sh + b * words, t, i + d, y);
      jac_add_into(RegPoint{&acc}, RegPoint{&y}, K, RegOut{&acc});
    }
    b ^= 1;
    put(sh + b * words, t, i, acc);
    __syncthreads();
  }
  if (tot != nullptr && i == 0) {  // slot 0 holds the tile's sum
    const size_t tld = static_cast<size_t>(rows) * tiles;
    const GlobalOut dst{{tot, tot + 16 * tld, tot + 32 * tld}, tld, row * tiles + tile};
#pragma unroll
    for (int q = 0; q < 3; ++q) dst.store(q, acc.c[q]);
  }
  Jac s;
  if (i + 1 < t) {
    get(sh + b * words, t, i + 1, s);
  } else {
    store_infinity(RegOut{&s}, K);
  }
  const GlobalOut dst{{out, out + 16 * ld, out + 32 * ld}, ld, 0};
  for (int j = k - 1;; --j) {
    if (c0 + j < chunks) {
      GlobalOut o = dst;
      o.i = e0 + j;
#pragma unroll
      for (int q = 0; q < 3; ++q) o.store(q, s.c[q]);
    }
    if (j == 0) break;
    load_chunk(in, ld, e0 + j, c0 + j < chunks, K, c);
    jac_add_into(RegPoint{&c}, RegPoint{&s}, K, RegOut{&s});
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
// T chunks (a power of two).  mode 0: the cluster schedule (k = 1, T <=
// CLUSTER_CHUNKS * CLUSTER_MAX), mode 2: the coarsened one (k chunks a
// thread, k a power of two <= T, T / k <= COARSE_MAX_THREADS); both write the
// in-tile exclusive suffixes into out and, when tot is not null, the tile
// totals (3, 16, rows, ceil(chunks / T)) into tot.  mode 1: out = in plus
// the tile suffixes given in add, (3, 16, rows, ceil(chunks / T)).
extern "C" int h2t_jac_suffix_scan(const void* in, const void* add, void* out, void* tot, int rows,
                                   int chunks, int T, int k, int mode, const void* consts, void* stream) {
  const bool pow2 = T > 0 && !(T & (T - 1)) && k > 0 && !(k & (k - 1)) && k <= T;
  const bool fits = mode == 1 || (mode == 0 && k == 1 && T <= CLUSTER_CHUNKS * CLUSTER_MAX) ||
                    (mode == 2 && T / k <= COARSE_MAX_THREADS);
  if (rows <= 0 || chunks <= 0 || !pow2 || !fits) return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto src = static_cast<const uint32_t*>(in);
  const auto dst = static_cast<uint32_t*>(out);
  const auto sums = static_cast<uint32_t*>(tot);
  const size_t tiles = static_cast<size_t>(rows) * ((chunks + T - 1) / T);
  if (mode == 1) {
    const size_t blocks = (static_cast<size_t>(rows) * chunks + OFFSET_THREADS - 1) / OFFSET_THREADS;
    if (blocks > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
    jac_suffix_scan_offsets_kernel<<<static_cast<unsigned>(blocks), OFFSET_THREADS, 0, s>>>(
        src, static_cast<const uint32_t*>(add), dst, rows, chunks, T, C);
  } else if (mode == 2) {
    if (tiles > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
    const size_t shared = 2 * 3 * WORDS * sizeof(uint32_t) * (T / k);
    jac_suffix_scan_coarse_kernel<<<static_cast<unsigned>(tiles), T / k, shared, s>>>(src, dst, sums, rows, chunks, T,
                                                                                     k, C);
  } else {
    const int per = T < CLUSTER_CHUNKS ? T : CLUSTER_CHUNKS;
    const int cs = T / per;
    if (tiles * cs > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(tiles * cs));
    cfg.blockDim = dim3(GROUP * per < 32 ? 32 : GROUP * per);  // whole warps: the group's shuffles span one
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, jac_suffix_scan_cluster_kernel, src, dst, sums, rows, chunks, T, C);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

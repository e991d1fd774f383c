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
//   bytes in eight 16-byte pieces.
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
// What bounds them.  msm_chunk_acc: the IMADs of its R C (q - 1) mixed adds,
// in chains of q dependent adds a lane; the gathers are random (the entries
// are sorted by digit), so each lane fetches its point ACC_STAGES rounds
// ahead into shared memory with cp.async, and the gather leaves the chain.
// Two schedules (ec/cuda_jac.py:acc_plan picks one from the lane count, by
// thresholds measured on the card; PERF.md):
// - few lanes (a scalar set at 2^11 is 32 rows of 256 chunks: 8,192 lanes,
//   64 blocks of one thread a lane, one warp on a scheduler of half the
//   SMs, 5.6 us a round): the chain.  A lane runs on a group of four
//   threads (jac.cuh: madd_group, four levels of products instead of a
//   chain of 11), four times the warps: a round takes 2.9 us with one warp
//   on a scheduler and 3.8 us with the two of one set, where the warps
//   share the scheduler's IMAD and ALU pipes.
// - many lanes (2-20 sets, the 2^16 and 2^18 windows): the IMAD pipes,
//   which a group's 16 products a madd load more than one thread's 11.  A
//   thread a lane, 128 a block at 126 registers, four blocks an SM: 67,584
//   lanes a wave, so 8 and 16 sets (65,536, 131,072) take whole waves
//   (three blocks an SM left 8 sets 1.3 waves).  Where three an SM leave
//   the fuller last wave (2^10 points at 20 sets: 1.6 waves against 1.2)
//   acc_plan picks the same rounds held at three by a smaller shared
//   memory carveout (msm_chunk_acc_thread3_kernel).
// jac_suffix_scan, measured on the H100 (PERF.md):
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

constexpr int CLUSTER_CHUNKS = 32;  // the chunks a block of the cluster scan holds
constexpr int CLUSTER_THREADS = GROUP * CLUSTER_CHUNKS;
constexpr int CLUSTER_MAX = 8;  // its blocks a cluster: tiles of up to 256 chunks
constexpr int CLUSTER_BLOCKS_SM = 3;  // blocks an SM: 168 registers a thread
constexpr int COARSE_MAX_THREADS = 256;  // the most threads a block of the coarsened scan has
constexpr int OFFSET_THREADS = 128;

// msm_chunk_acc's blocks: a thread schedule's 128 threads at four blocks an
// SM (126 registers), a group schedule's 128 threads (32 lanes) at three
// (166 registers); other shapes measured slower (PERF.md).
constexpr int ACC_THREAD_BLOCK = 128;
constexpr int ACC_THREAD_BLOCKS_SM = 4;
constexpr int ACC_GROUP_BLOCK = 128;
constexpr int ACC_GROUP_BLOCKS_SM = 3;
constexpr int ACC_GROUP_LANES = ACC_GROUP_BLOCK / GROUP;
constexpr int ACC_QMAX = 16;   // the most rounds a lane: the reference's q is 8 or 16
constexpr int ACC_STAGES = 2;  // a lane's points in flight

// cp.async: 16 bytes from device memory into shared memory, in groups
// committed and waited on by the issuing thread.  Cached in L1 (.ca): a
// 2^11-point table (256 KB) is read by every row, and past L1 (.cg) the
// thread schedule measured slower at every batch (PERF.md).
__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// every group but the newest ACC_STAGES - 1 has landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;" ::"n"(ACC_STAGES - 1) : "memory");
}

// A group lane's q entries, read once: step s (the rounds run from the last
// entry down, s = q - 1 - pos) adds point ord[s], negated where bit s of neg
// is set.  shift() moves step s + 1's index to ord[0], so every index stays
// a register.
struct Entries {
  int ord[ACC_QMAX];
  uint32_t neg;
  __device__ __forceinline__ void load(const int* __restrict__ order, const uint8_t* __restrict__ sign, size_t row,
                                       size_t chunk, int chunks, int q) {
    neg = 0;
#pragma unroll
    for (int s = 0; s < ACC_QMAX; ++s) {
      ord[s] = 0;
      if (s < q) {
        const size_t e = (row * q + (q - 1 - s)) * chunks + chunk;
        ord[s] = __ldg(order + e);
        neg |= static_cast<uint32_t>(__ldg(sign + e) != 0) << s;
      }
    }
  }
  __device__ __forceinline__ void shift() {
#pragma unroll
    for (int s = 0; s + 1 < ACC_QMAX; ++s) ord[s] = ord[s + 1];
  }
};

// y = -y (p - y, 0 kept as 0, as DeviceField.neg does) where neg: a select,
// not a branch, so that the compiler may schedule it beside the round
// before.
__device__ __forceinline__ void negate_if(uint32_t y[WORDS], bool neg, const Modulus& M) {
  const uint32_t zero[WORDS] = {};
  uint32_t n[WORDS];
  cc::sub(zero, y, M, n);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) y[k] = neg ? n[k] : y[k];
}

// x and y of the point in slot i of a stage: piece v (16 bytes, four limbs)
// of a (n, 32) table row at [v][i], so that a warp's neighbouring slots
// read neighbouring banks.
template <int N>
__device__ __forceinline__ void read_point(const uint4* buf, int i, uint32_t x[WORDS], uint32_t y[WORDS]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const uint4 a = buf[v * N + i];
    uint32_t* w = v < 4 ? x + 2 * v : y + 2 * (v - 4);
    w[0] = a.x | (a.y << 16);
    w[1] = a.z | (a.w << 16);
  }
}

// Many lanes: a thread a lane, jac_madd_into's 11 products in one chain.
// Each round's point was fetched ACC_STAGES rounds ahead into this thread's
// slot of a stage (cp.async, eight pieces), so the gather overlaps the
// rounds before it; the thread reads back only its own copies, so no
// barrier is needed.  The signs are one register of bits, read at the
// start.  Two kernels run these rounds: msm_chunk_acc_thread_kernel at four
// blocks an SM, as the registers allow, and msm_chunk_acc_thread3_kernel,
// held at three by a smaller shared memory carveout (set_thread3_carveout).
__device__ __forceinline__ void chunk_acc_thread(const uint32_t* __restrict__ pts, const int* __restrict__ order,
                                                 const uint8_t* __restrict__ sign, uint32_t* __restrict__ sfx,
                                                 uint32_t* __restrict__ tot, int rows, int chunks, int q,
                                                 ModulusOne C) {
  __shared__ uint4 stage[ACC_STAGES][8][ACC_THREAD_BLOCK];
  const int i = threadIdx.x;
  const size_t lane = static_cast<size_t>(blockIdx.x) * ACC_THREAD_BLOCK + i;
  const size_t lanes = static_cast<size_t>(rows) * chunks;
  if (lane >= lanes) return;
  // entry pos of lane (row, chunk), and its running sum in sfx (3, 16, R,
  // q C), at (row q + pos) C + chunk
  const size_t row = lane / chunks, chunk = lane % chunks;
  auto entry = [&](int s) { return (row * q + (q - 1 - s)) * chunks + chunk; };  // step s's entry
  uint32_t neg = 0;
  for (int s = 0; s < q; ++s) neg |= static_cast<uint32_t>(__ldg(sign + entry(s)) != 0) << s;
  const uint4* table = reinterpret_cast<const uint4*>(pts);
  auto fetch = [&](int buf, int idx) {
#pragma unroll
    for (int v = 0; v < 8; ++v) cp_async16(&stage[buf][v][i], table + 8 * static_cast<size_t>(idx) + v);
  };
#pragma unroll
  for (int s = 0; s < ACC_STAGES; ++s) {
    if (s < q) fetch(s, __ldg(order + entry(s)));
    cp_async_commit();
  }
  // the point index a fetch needs is read a round before it: off the chain,
  // in one register (a lane's q indices held at once cost the registers of
  // a fourth block an SM)
  int ahead = ACC_STAGES < q ? __ldg(order + entry(ACC_STAGES)) : 0;
  const size_t ld = lanes * q;
  const GlobalOut sfx_out{{sfx, sfx + 16 * ld, sfx + 32 * ld}, ld, 0};
  Jac acc;
  store_infinity(RegOut{&acc}, C);
  for (int s = 0; s < q; ++s) {
    cp_async_wait_stage();  // step s's point has landed
    uint32_t qx[WORDS], qy[WORDS];
    read_point<ACC_THREAD_BLOCK>(&stage[s % ACC_STAGES][0][0], i, qx, qy);
    if (s + ACC_STAGES < q) fetch(s % ACC_STAGES, ahead);
    cp_async_commit();
    if (s + ACC_STAGES + 1 < q) ahead = __ldg(order + entry(s + ACC_STAGES + 1));
    negate_if(qy, (neg >> s) & 1, C.M);
    jac_madd_into(RegPoint{&acc}, qx, qy, C, RegOut{&acc});
    GlobalOut o = sfx_out;
    o.i = entry(s);
#pragma unroll
    for (int k = 0; k < 3; ++k) o.store(k, acc.c[k]);
  }
  const GlobalOut t{{tot, tot + 16 * lanes, tot + 32 * lanes}, lanes, lane};
#pragma unroll
  for (int k = 0; k < 3; ++k) t.store(k, acc.c[k]);
}

__global__ void __launch_bounds__(ACC_THREAD_BLOCK, ACC_THREAD_BLOCKS_SM)
msm_chunk_acc_thread_kernel(const uint32_t* __restrict__ pts, const int* __restrict__ order,
                            const uint8_t* __restrict__ sign, uint32_t* __restrict__ sfx, uint32_t* __restrict__ tot,
                            int rows, int chunks, int q, ModulusOne C) {
  chunk_acc_thread(pts, order, sign, sfx, tot, rows, chunks, q, C);
}

__global__ void __launch_bounds__(ACC_THREAD_BLOCK, ACC_THREAD_BLOCKS_SM)
msm_chunk_acc_thread3_kernel(const uint32_t* __restrict__ pts, const int* __restrict__ order,
                             const uint8_t* __restrict__ sign, uint32_t* __restrict__ sfx, uint32_t* __restrict__ tot,
                             int rows, int chunks, int q, ModulusOne C) {
  chunk_acc_thread(pts, order, sign, sfx, tot, rows, chunks, q, C);
}

// Few lanes: a group of four threads a lane (jac.cuh: madd_group, four
// levels of products), ACC_GROUP_LANES lanes a block.  Each rank fetches two
// of the eight pieces of the round ACC_STAGES ahead; after the wait a
// __syncwarp makes every rank's pieces visible to the group, and a second
// one keeps the stage until all four have read it.  Groups past the last
// lane redo the last lane's work and store nothing: the shuffles need whole
// warps.  Rank k < 3 stores coordinate k.
__global__ void __launch_bounds__(ACC_GROUP_BLOCK, ACC_GROUP_BLOCKS_SM)
msm_chunk_acc_group_kernel(const uint32_t* __restrict__ pts, const int* __restrict__ order,
                           const uint8_t* __restrict__ sign, uint32_t* __restrict__ sfx, uint32_t* __restrict__ tot,
                           int rows, int chunks, int q, ModulusOne C) {
  __shared__ uint4 stage[ACC_STAGES][8][ACC_GROUP_LANES];
  const int g = threadIdx.x % GROUP, li = threadIdx.x / GROUP;
  const size_t lanes = static_cast<size_t>(rows) * chunks;
  const size_t own = static_cast<size_t>(blockIdx.x) * ACC_GROUP_LANES + li;
  const bool real = own < lanes;
  const size_t lane = real ? own : lanes - 1;
  const size_t row = lane / chunks, chunk = lane % chunks;
  Entries en;
  en.load(order, sign, row, chunk, chunks, q);
  const uint4* table = reinterpret_cast<const uint4*>(pts);
  auto fetch = [&](int buf, int idx) {
    const uint4* src = table + 8 * static_cast<size_t>(idx) + 2 * g;
    cp_async16(&stage[buf][2 * g][li], src);
    cp_async16(&stage[buf][2 * g + 1][li], src + 1);
  };
#pragma unroll
  for (int s = 0; s < ACC_STAGES; ++s) {
    if (s < q) fetch(s, en.ord[s]);
    cp_async_commit();
  }
  const size_t ld = lanes * q;
  uint32_t x[WORDS], y[WORDS], z[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {  // infinity
    x[k] = 0;
    y[k] = C.one[k];
    z[k] = 0;
  }
  for (int s = 0; s < q; ++s) {
    cp_async_wait_stage();
    __syncwarp();
    uint32_t qx[WORDS], qy[WORDS];
    read_point<ACC_GROUP_LANES>(&stage[s % ACC_STAGES][0][0], li, qx, qy);
    __syncwarp();
    if (s + ACC_STAGES < q) fetch(s % ACC_STAGES, en.ord[ACC_STAGES]);
    cp_async_commit();
    en.shift();
    negate_if(qy, (en.neg >> s) & 1, C.M);
    madd_group(g, x, y, z, qx, qy, C);
    if (real && g < 3) {
      uint32_t v[WORDS];
#pragma unroll
      for (int k = 0; k < WORDS; ++k) v[k] = g == 0 ? x[k] : g == 1 ? y[k] : z[k];
      store_elem(sfx + static_cast<size_t>(g) * 16 * ld, ld, (row * q + (q - 1 - s)) * chunks + chunk, v);
    }
  }
  if (real && g < 3) {
    uint32_t v[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) v[k] = g == 0 ? x[k] : g == 1 ? y[k] : z[k];
    store_elem(tot + static_cast<size_t>(g) * 16 * lanes, lanes, lane, v);
  }
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

// Holds msm_chunk_acc_thread3_kernel at three blocks an SM: a shared memory
// carveout (a percentage of the SM's) that three blocks' shared memory fits
// and four do not.  Set once for each device (a function's attribute holds
// on the device that was current when it was set).
cudaError_t set_thread3_carveout() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return rc;
  cudaFuncAttributes attr;
  int smem = 0, reserved = 0;
  rc = cudaFuncGetAttributes(&attr, msm_chunk_acc_thread3_kernel);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(msm_chunk_acc_thread3_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(300 * (attr.sharedSizeBytes + reserved) / smem));
  if (rc == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return rc;
}

}  // namespace

// The intra-chunk rounds of R rows x C chunks of q <= ACC_QMAX sorted
// entries: order and sign (R, q, C), position-major (int32 point indices
// into pts, bytes 0/1); pts the (n, 32) point table (16-byte aligned); sfx
// (3, 16, R, q C) the running sums, position-major, tot (3, 16, R, C) the
// chunk totals.  mode 0: the group schedule, 1: the thread schedule at four
// blocks an SM, 2: at three (ec/cuda_jac.py:acc_plan picks one).
extern "C" int h2t_msm_chunk_acc(const void* pts, const void* order, const void* sign, void* sfx, void* tot,
                                 int rows, int chunks, int q, int mode, const void* consts, void* stream) {
  if (rows <= 0 || chunks <= 0 || q <= 0 || q > ACC_QMAX || mode < 0 || mode > 2 ||
      reinterpret_cast<uintptr_t>(pts) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne C = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const size_t lanes = static_cast<size_t>(rows) * chunks;
  const int per = mode == 0 ? ACC_GROUP_LANES : ACC_THREAD_BLOCK;
  const size_t blocks = (lanes + per - 1) / per;
  if (blocks > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 2) {
    const cudaError_t rc = set_thread3_carveout();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const auto kernel = mode == 0   ? msm_chunk_acc_group_kernel
                      : mode == 1 ? msm_chunk_acc_thread_kernel
                                  : msm_chunk_acc_thread3_kernel;
  kernel<<<static_cast<unsigned>(blocks), mode == 0 ? ACC_GROUP_BLOCK : ACC_THREAD_BLOCK, 0,
           static_cast<cudaStream_t>(stream)>>>(
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

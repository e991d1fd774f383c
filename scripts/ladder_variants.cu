// Two redesigns of jac_ladder (halo2_tpu_torch/csrc/ladder.cu) that issue
// fewer complete adds than a warp running the add whenever any of its lanes
// has the row's bit set.  They were measured on one H100 and not kept; this
// file holds them so that scripts/ladder_probe.py can time them beside the
// kernel.  Same contract as h2t_jac_ladder: lane i of m holds a point and
// the (nbits, m) uint8 bit rows of its scalar (LSB first); out (3, 16, m)
// x, y, z; the same formulas (jac.cuh's jac_dbl_into and jac_add_into), so
// the output equals the kernel's limb for limb.
//
// - ring<Q>: each lane queues base_r where its bit is set into a ring of Q
//   slots in shared memory; an add step (acc plus the oldest queued base)
//   runs when every lane of the warp has one queued, when some lane's ring
//   is full, and after the last row while any is queued.
// - compact: each row, the block's set bits hand their base to
//   consecutive threads (through shared memory, two barriers a row), so
//   the row's adds run on ceil(set bits / 32) warps; acc in shared memory.
//
// Build (scripts/ladder_probe.py does): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -I
// halo2_tpu_torch/csrc -o <lib> scripts/ladder_variants.cu

#include "jac.cuh"

using namespace h2t;

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 3;

__device__ __forceinline__ void set_infinity(Jac& p, const ModulusOne& K) {  // (0, 1, 0)
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    p.c[0][k] = 0;
    p.c[1][k] = K.one[k];
    p.c[2][k] = 0;
  }
}

// slot s of the ring, word j of coordinate k of the block's thread t at
// q[s][k WORDS + j][t] (a warp's 32 threads on 32 banks)
struct QueuedPoint {
  uint32_t (*q)[3 * WORDS][THREADS];
  int slot, t;
  __device__ __forceinline__ void load(int k, uint32_t v[WORDS]) const {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) v[j] = q[slot][k * WORDS + j][t];
  }
};

template <int Q>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ladder_ring_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                   const uint32_t* __restrict__ pz, const uint8_t* __restrict__ bits,
                   uint32_t* __restrict__ out, int m, int nbits, ModulusOne K) {
  __shared__ uint32_t q[Q][3 * WORDS][THREADS];
  const int t = threadIdx.x;
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + t;
  const bool active = i < static_cast<size_t>(m);
  const unsigned lanes = __ballot_sync(0xFFFFFFFFu, active);
  if (!lanes) return;  // the whole warp past m
  const size_t ld = static_cast<size_t>(m);
  Jac acc, base;
  set_infinity(acc, K);
  set_infinity(base, K);
  if (active) {
    load_elem(px, ld, i, base.c[0]);
    load_elem(py, ld, i, base.c[1]);
    load_elem(pz, ld, i, base.c[2]);
  }
  int head = 0, count = 0;  // the ring's oldest slot and its queued bases
  for (int r = 0;; ++r) {
    const bool row = r < nbits;  // the same on every thread
    if (!row && !__any_sync(0xFFFFFFFFu, count > 0)) break;
    if (row && active && bits[static_cast<size_t>(r) * ld + i]) {
      const int slot = (head + count) % Q;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < WORDS; ++j) q[slot][k * WORDS + j][t] = base.c[k][j];
      ++count;
    }
    if (!row || __ballot_sync(0xFFFFFFFFu, count > 0) == lanes || __any_sync(0xFFFFFFFFu, count == Q)) {
      if (count > 0) {
        jac_add_into(RegPoint{&acc}, QueuedPoint{q, head, t}, K, RegOut{&acc});
        head = (head + 1) % Q;
        --count;
      }
    }
    if (r + 1 < nbits) jac_dbl_into(base.c[0], base.c[1], base.c[2], K.M, RegOut{&base});
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < 3; ++k) store_elem(out + static_cast<size_t>(k) * 16 * ld, ld, i, acc.c[k]);
  }
}

// a point in shared memory: word j of coordinate k of column c at s[k WORDS + j][c]
struct SharedCol {
  uint32_t (*s)[THREADS];
  int c;
  __device__ __forceinline__ void load(int k, uint32_t v[WORDS]) const {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) v[j] = s[k * WORDS + j][c];
  }
  __device__ __forceinline__ void store(int k, const uint32_t v[WORDS]) const {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) s[k * WORDS + j][c] = v[j];
  }
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ladder_compact_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz, const uint8_t* __restrict__ bits,
                      uint32_t* __restrict__ out, int m, int nbits, ModulusOne K) {
  constexpr int WARPS = THREADS / 32;
  __shared__ uint32_t acc_s[3 * WORDS][THREADS];   // lane t's acc in column t
  __shared__ uint32_t base_s[3 * WORDS][THREADS];  // a row's bases to add, compacted
  __shared__ int owner_s[THREADS];                 // the lane of each compacted base
  __shared__ int count_s[WARPS];                   // a row's set bits a warp
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + t;
  const bool active = i < static_cast<size_t>(m);  // every thread stays: the barriers span the block
  const size_t ld = static_cast<size_t>(m);
  Jac base;
  set_infinity(base, K);
  if (active) {
    load_elem(px, ld, i, base.c[0]);
    load_elem(py, ld, i, base.c[1]);
    load_elem(pz, ld, i, base.c[2]);
  }
  {
    Jac inf;
    set_infinity(inf, K);
#pragma unroll
    for (int k = 0; k < 3; ++k) SharedCol{acc_s, t}.store(k, inf.c[k]);
  }
  for (int r = 0; r < nbits; ++r) {
    const bool bit = active && bits[static_cast<size_t>(r) * ld + i];
    const unsigned vote = __ballot_sync(0xFFFFFFFFu, bit);
    if (l == 0) count_s[w] = __popc(vote);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      offset += k < w ? count_s[k] : 0;
      total += count_s[k];
    }
    if (bit) {
      const int slot = offset + __popc(vote & ((1u << l) - 1));
      owner_s[slot] = t;
#pragma unroll
      for (int k = 0; k < 3; ++k) SharedCol{base_s, slot}.store(k, base.c[k]);
    }
    __syncthreads();
    if (t < total) {
      const SharedCol acc{acc_s, owner_s[t]};
      jac_add_into(acc, SharedCol{base_s, t}, K, acc);
    }
    if (r + 1 < nbits) jac_dbl_into(base.c[0], base.c[1], base.c[2], K.M, RegOut{&base});
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint32_t v[WORDS];
      SharedCol{acc_s, t}.load(k, v);
      store_elem(out + static_cast<size_t>(k) * 16 * ld, ld, i, v);
    }
  }
}

}  // namespace

// variant 0: ring<4> (48 KB of shared memory a block), 1: ring<2>, 2: compact
extern "C" int ladder_variant(const void* px, const void* py, const void* pz, const void* bits, void* out, int m,
                              int nbits, int variant, const void* consts, void* stream) {
  if (m <= 0 || nbits < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne K = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(px);
  const auto* y = static_cast<const uint32_t*>(py);
  const auto* z = static_cast<const uint32_t*>(pz);
  const auto* b = static_cast<const uint8_t*>(bits);
  auto* o = static_cast<uint32_t*>(out);
  const int blocks = (m + THREADS - 1) / THREADS;
  if (variant == 0) {
    ladder_ring_kernel<4><<<blocks, THREADS, 0, s>>>(x, y, z, b, o, m, nbits, K);
  } else if (variant == 1) {
    ladder_ring_kernel<2><<<blocks, THREADS, 0, s>>>(x, y, z, b, o, m, nbits, K);
  } else if (variant == 2) {
    ladder_compact_kernel<<<blocks, THREADS, 0, s>>>(x, y, z, b, o, m, nbits, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

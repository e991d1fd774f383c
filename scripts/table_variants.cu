// The variants of jac_fixed_base (halo2_tpu_torch/csrc/ladder.cu) and
// poseidon_hash (halo2_tpu_torch/csrc/poseidon.cu) that were measured on
// one H100 and not kept; this file holds them so that
// scripts/table_probe.py can check and time them beside the kernels.
//
// - fb_variant(v, ...): jac_fixed_base's contract (lane i's scalar in
//   column i of (8, m) words, the window table of ec/cuda_jac.py:
//   fixed_base_table at the variant's w, out (3, 16, m)) and its window
//   loop on jac.cuh's jac_madd_into, at another window width, launch
//   bound or table read:
//     0  w = 4, the table through __ldg, 128 threads, 3 blocks an SM
//     1  w = 5, the table through __ldg, 128 threads, 3 blocks an SM
//     2  w = 6, the table through __ldg, 128 threads, 4 blocks an SM (at
//        most 128 registers, where the kernel's 3 blocks allow 168)
//     3  w = 4, one bulk copy of the table into shared memory a block
//        (bulk.cuh), 256 threads, 2 blocks an SM
//     4  w = 5, the same copy, 256 threads, 2 blocks an SM
// - sponge_ldg(...): h2t_poseidon_hash's contract in hash mode for width 5
//   and CcArith (BN254 Fr, MySpec(5, 4)), poseidon.cu's own permutation
//   reading the constant table from device memory (a const __restrict__
//   argument, which nvcc loads through the read-only path, __ldg's
//   instruction; scripts/table_probe.py counts those loads in the SASS)
//   where the kernel copies it into shared memory a block.
//
// Build (scripts/table_probe.py does): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// -Xptxas -v -I halo2_tpu_torch/csrc -o <lib> scripts/table_variants.cu

#include "ladder.cu"
#include "poseidon.cu"

namespace {

template <int W, bool STAGED, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fb_variant_kernel(const uint32_t* __restrict__ scalars, const uint4* __restrict__ table,
                  uint32_t* __restrict__ out, int m, ModulusOne K) {
  constexpr int DIGITS = (1 << W) - 1, WINDOWS = (256 + W - 1) / W;
  const uint4* tab = table;
  if constexpr (STAGED) {
    extern __shared__ __align__(16) uint4 staged[];
    __shared__ uint64_t bar;
    bulk_stage(staged, table, WINDOWS * DIGITS * 64u, &bar);
    tab = staged;
  }
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  const size_t ld = static_cast<size_t>(m);
  uint32_t s[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) s[k] = scalars[k * ld + i];
  Jac acc;
  set_infinity(acc, K);
#pragma unroll 1
  for (int j = 0; j < WINDOWS; ++j) {
    const uint32_t d = s[0] & DIGITS;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) s[k] = (s[k] >> W) | (k + 1 < WORDS ? s[k + 1] << (32 - W) : 0u);
    if (d == 0) continue;
    uint32_t qx[WORDS], qy[WORDS];
    const int e = j * DIGITS + static_cast<int>(d) - 1;
    if constexpr (STAGED) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint4 v = tab[4 * e + h];
        uint32_t* dst = h < 2 ? qx + 4 * h : qy + 4 * (h - 2);
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      load_entry(tab, e, qx, qy);
    }
    jac_madd_into(RegPoint{&acc}, qx, qy, K, RegOut{&acc});
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) store_elem(out + static_cast<size_t>(k) * 16 * ld, ld, i, acc.c[k]);
}

template <int W, bool STAGED, int THREADS, int MIN_BLOCKS>
int fb_launch(const void* scalars, const void* table, void* out, int m, const ModulusOne& K, cudaStream_t s) {
  const int smem = STAGED ? ((256 + W - 1) / W) * ((1 << W) - 1) * 64 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(fb_variant_kernel<W, STAGED, THREADS, MIN_BLOCKS>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  fb_variant_kernel<W, STAGED, THREADS, MIN_BLOCKS><<<(m + THREADS - 1) / THREADS, THREADS, smem, s>>>(
      static_cast<const uint32_t*>(scalars), static_cast<const uint4*>(table), static_cast<uint32_t*>(out), m, K);
  return static_cast<int>(cudaGetLastError());
}

template <int W, class A>
__global__ void __launch_bounds__(SPONGE_THREADS, SPONGE_MIN_BLOCKS)
sponge_ldg_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int m, int n_msg,
                  const uint4* __restrict__ table, int r_f, int r_p, Modulus M, Word8 cap) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  const size_t ld = static_cast<size_t>(m);
  constexpr int RATE = W - 1;
  uint32_t st[W][WORDS];
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int k = 0; k < WORDS; ++k) st[i][k] = i == RATE ? cap.w[k] : 0;
#pragma unroll 1
  for (int c = 0; c < (n_msg + RATE - 1) / RATE; ++c) {
#pragma unroll
    for (int i = 0; i < RATE; ++i) {
      if (c * RATE + i < n_msg) {
        uint32_t v[WORDS];
        load_elem(in + static_cast<size_t>(c * RATE + i) * 16 * ld, ld, idx, v);
        A::add(st[i], v, M, st[i]);
      }
    }
    permute<W, A>(st, table, r_f, r_p, M);
  }
  store_elem(out, ld, idx, st[0]);
}

}  // namespace

extern "C" int fb_variant(int v, const void* scalars, const void* table, void* out, int m, const void* consts,
                          void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ModulusOne K = modulus_one_from_host(static_cast<const uint32_t*>(consts));
  const auto s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return fb_launch<4, false, 128, 3>(scalars, table, out, m, K, s);
    case 1: return fb_launch<5, false, 128, 3>(scalars, table, out, m, K, s);
    case 2: return fb_launch<6, false, 128, 4>(scalars, table, out, m, K, s);
    case 3: return fb_launch<4, true, 256, 2>(scalars, table, out, m, K, s);
    case 4: return fb_launch<5, true, 256, 2>(scalars, table, out, m, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// h2t_poseidon_hash's arguments in hash mode; width 5 and arith 0 only.
extern "C" int sponge_ldg(const void* in, void* out, int m, int n_msg, int width, const void* table, int r_f,
                          int r_p, const void* modulus, const void* cap, int arith, void* stream) {
  if (m <= 0 || n_msg < 0 || r_f < 1 || r_p < 1 || width != 5 || arith != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  Word8 c;
  for (int k = 0; k < WORDS; ++k) c.w[k] = static_cast<const uint32_t*>(cap)[k];
  sponge_ldg_kernel<5, CcArith><<<(m + SPONGE_THREADS - 1) / SPONGE_THREADS, SPONGE_THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), m, n_msg, static_cast<const uint4*>(table), r_f,
      r_p, M, c);
  return static_cast<int>(cudaGetLastError());
}

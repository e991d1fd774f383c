// Batched prime-field add and subtract: out = a + b mod p and out = a - b mod p,
// canonical (< p); the negation -a is 0 - a, a subtract whose left operand is
// one broadcast zero.
//
// No Pallas counterpart: these replace the jnp add, sub and neg of
// halo2_tpu/field/device.py:145-157 (DeviceField.add/sub/neg), which XLA
// fuses into whatever program calls them.  Here each is one launch, where the
// port's plain version (field/cuda_ops.py) is a chain of ~95 int64 torch ops.
//
// What bounds them on an H100: each element moves 192 bytes (two operands and
// the result, 16 int32 limbs each) for about 16 32-bit adds, so they are bound
// by memory traffic (3.35 TB/s).  One thread per element; neighbouring
// threads take neighbouring elements, so every limb load and store is
// coalesced (field.cuh), and each limb is read and written once.
//
// Either operand of mod_sub, and b of mod_add (the add commutes), may be one
// broadcast element (a (16, 1) column: a round constant, a zero); m is
// arbitrary (bounds check, no padding).  Templates on the arithmetic
// (arith.cuh): arith 0 = CcArith (p < 2^254), 1 = WideArith.

#include "arith.cuh"

using namespace h2t;

namespace {

constexpr int THREADS = 256;

template <class A>
__global__ void __launch_bounds__(THREADS)
mod_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int m, int b_bcast, Modulus M) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  uint32_t x[WORDS], y[WORDS], r[WORDS];
  load_elem(a, m, idx, x);
  if (b_bcast)
    load_elem(b, 1, 0, y);
  else
    load_elem(b, m, idx, y);
  A::add(x, y, M, r);
  store_elem(out, m, idx, r);
}

template <class A>
__global__ void __launch_bounds__(THREADS)
mod_sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int m, int a_bcast, int b_bcast, Modulus M) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m)) return;
  uint32_t x[WORDS], y[WORDS], r[WORDS];
  if (a_bcast)
    load_elem(a, 1, 0, x);
  else
    load_elem(a, m, idx, x);
  if (b_bcast)
    load_elem(b, 1, 0, y);
  else
    load_elem(b, m, idx, y);
  A::sub(x, y, M, r);
  store_elem(out, m, idx, r);
}

int blocks(int m) { return (m + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int h2t_mod_add(const void* a, const void* b, void* out, int m, int b_bcast,
                           const void* modulus, int arith, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  if (arith == 0) {
    mod_add_kernel<CcArith><<<blocks(m), THREADS, 0, s>>>(x, y, o, m, b_bcast, M);
  } else if (arith == 1) {
    mod_add_kernel<WideArith><<<blocks(m), THREADS, 0, s>>>(x, y, o, m, b_bcast, M);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int h2t_mod_sub(const void* a, const void* b, void* out, int m, int a_bcast, int b_bcast,
                           const void* modulus, int arith, void* stream) {
  const Modulus M = modulus_from_host(static_cast<const uint32_t*>(modulus));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  if (arith == 0) {
    mod_sub_kernel<CcArith><<<blocks(m), THREADS, 0, s>>>(x, y, o, m, a_bcast, b_bcast, M);
  } else if (arith == 1) {
    mod_sub_kernel<WideArith><<<blocks(m), THREADS, 0, s>>>(x, y, o, m, a_bcast, b_bcast, M);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

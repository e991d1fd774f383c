// The two arithmetics the kernels are templates on, both giving the canonical
// values of the plain versions (ntt.cu, vm.cu, field_ops.cu, and mont_mul.cu's
// mont_pow):
//
// - CcArith: field_cc.cuh's PTX carry chains (two IMAD.WIDE chains per row
//   of the product), whose bounds hold only for p < 2^254: BN254's Fr and Fq;
// - WideArith: field.cuh's 64-bit accumulators, right for any p < 2^256: the
//   255-bit Pasta fields.
//
// The Python wrappers pick one from the modulus (cuda_ntt._arith) and pass
// it as an int: 0 = CcArith, 1 = WideArith.
#pragma once

#include "field_cc.cuh"

namespace h2t {

struct CcArith {
  static __device__ __forceinline__ void mul(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                             const Modulus& M, uint32_t r[WORDS]) {
    cc::mul(a, b, M, r);
  }
  static __device__ __forceinline__ void sqr(const uint32_t a[WORDS], const Modulus& M,
                                             uint32_t r[WORDS]) {
    cc::sqr(a, M, r);
  }
  static __device__ __forceinline__ void add(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                             const Modulus& M, uint32_t r[WORDS]) {
    cc::add(a, b, M, r);
  }
  static __device__ __forceinline__ void sub(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                             const Modulus& M, uint32_t r[WORDS]) {
    cc::sub(a, b, M, r);
  }
};

struct WideArith {
  static __device__ __forceinline__ void mul(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                             const Modulus& M, uint32_t r[WORDS]) {
    mont_mul(a, b, M, r);
  }
  static __device__ __forceinline__ void sqr(const uint32_t a[WORDS], const Modulus& M,
                                             uint32_t r[WORDS]) {
    mont_sqr(a, M, r);
  }
  static __device__ __forceinline__ void add(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                             const Modulus& M, uint32_t r[WORDS]) {
    mod_add(a, b, M, r);
  }
  static __device__ __forceinline__ void sub(const uint32_t a[WORDS], const uint32_t b[WORDS],
                                             const Modulus& M, uint32_t r[WORDS]) {
    mod_sub(a, b, M, r);
  }
};

}  // namespace h2t

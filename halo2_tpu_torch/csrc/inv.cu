// Batched field inverse: out = a^-1 for a Montgomery array (a R -> a^-1 R),
// canonical, inv(0) = 0.
//
// Replaces halo2_tpu/field/device.py:251, DeviceField.inv: a^(p - 2) as a
// lax.scan over the exponent's bits (253 squares and 127 products) that XLA
// compiles into one device loop.  The port first ran that ladder as the
// mont_pow kernel (mont_mul.cu), one thread chaining 379 dependent
// Montgomery products of ~320 instructions each.  Here the inverse is the
// Bernstein-Yang safegcd in the form of libsecp256k1's modinv32
// (constant-time variant):
//
// - a value is 9 signed 30-bit limbs (270 bits: any 256-bit value, and the
//   signed intermediates);
// - f = p, g = x, d = 0, e = 1, zeta = -1 (zeta = -(delta + 1/2));
// - each batch runs 30 divsteps on the low limbs of f and g alone, which
//   yields a 2x2 transition matrix t scaled by 2^30, and then applies t /
//   2^30 to (f, g) exactly and to (d, e) mod p, adding the multiple of p
//   that clears the low 30 bits;
// - after the batches g = 0 and f = +-gcd(p, x) = +-1, and d = +-x^-1 mod p
//   (normalize: into [0, p), negated where f = -1).
//
// The count is fixed: BATCHES x 30 = 600 divsteps bound every lane, as
// modinv32 runs; its source states that 590 suffice for every input below
// 2^256 (the Bernstein-Yang bound for this half-delta divstep), which covers
// BN254's 254-bit and Pasta's 255-bit moduli (chip_smoke.py's
// _divsteps_needed reports the most a run's data needs).  So every lane of a
// warp runs the same instructions and the time does not depend on the
// value.  For x = a R the GCD gives x^-1 = a^-1 R^-1; one Montgomery product
// by R^3 mod p (a host constant) makes it a^-1 R.  x = 0 leaves d = 0, so
// inv(0) = 0.
//
// What bounds it on an H100: one element's chain.  600 divsteps and 20
// matrix applications follow one another, and a few thousand elements fill
// a few warps of each scheduler at most, so below ~2^15 elements the launch
// takes one warp's chain.  A warp alone on its scheduler issues about one
// instruction every two clocks (each of its instructions holds a 16-lane
// pipe two clocks), and a dependent instruction waits several more: one
// thread an element, a divstep at a time, ran 68-81 clocks a divstep
// (PERF.md).  So the design cuts both the instructions a lane issues and
// the chain; above ~2^15 elements, where every scheduler holds several
// warps, the issue slots bound it (chip_smoke.py's bound counts them):
//
// - G = 2 or 4 lanes of one warp an element (cuda_mul.inv_plan picks G
//   from the element count).  Every lane of the group runs the divsteps on
//   the shared low limbs and zeta (the same instructions, so no lane waits)
//   but keeps one matrix column: the lane of row 0 (u, q), of row 1 (v, r).
//   A batch trades one __shfl_xor_sync for the other row's entry, and each
//   lane applies its row of the matrix (update_row): at G = 2 to both (d, e)
//   and (f, g), at G = 4 to one of them (lanes 0-1 (d, e), 2-3 (f, g)).  A
//   lane holds its row's vector ("own": d or e, f or g) and the partner's
//   ("oth"); after its 9-limb product it receives the partner's new vector,
//   9 shuffles a pair.  The next batch's low limbs come from the (f, g)
//   lanes.  No block barrier past the table's load; the group's lanes are
//   one warp's.
// - The divsteps as table jumps: 28 of a batch's 30 are 7 lookups of 4
//   steps (divsteps_30_jumps) in a 16 KB table in shared memory
//   (cuda_mul.inv_jump_table), each a matrix of small integers applied to
//   (f, g) and to the column and an affine map of zeta; the last 2 are
//   single steps (divstep).  A lookup's chain is its index, the shared-
//   memory read and two products, against ~5 dependent instructions a
//   single step.
// - Each limb of update_row sums its three products apart from the carry
//   (dot3), so the carry is one 64-bit add and shift a limb; the batch loop
//   is unrolled by two so that one batch's last limbs overlap the next
//   batch's jumps.
//
// The closing product is arith.cuh's: the carry chains for BN254's Fr and
// Fq, 64-bit accumulators for Pasta.  Times, cycles a divstep and the
// share of the least issue slots' time on one NVIDIA H100 80GB HBM3 at
// 700 W: PERF.md, row 12.

#include "arith.cuh"

using namespace h2t;

namespace {

constexpr int INV_THREADS = 128;
constexpr int LIMBS30 = 9;     // signed 30-bit limbs a value
constexpr int BATCHES = 20;    // of STEPS divsteps: 600 >= 590
constexpr int STEPS = 30;
constexpr uint32_t M30 = 0x3FFFFFFFu;
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;
// the table jumps (cuda_mul.INV_JUMP, INV_JUMPS, INV_ZETA_CLAMP): JUMPS
// jumps of JUMP divsteps a batch; entries for zeta clamped to [ZLO, ZHI],
// f mod 2^JUMP (odd) and g mod 2^JUMP
constexpr int JUMP = 4, JUMPS = 7, ZLO = -4, ZHI = 3;
constexpr int JUMP_TABLE = (ZHI - ZLO + 1) << (2 * JUMP - 1);

// The kernel's constants, from a 27-word host array: p and n0 (words 0-8,
// the closing product's), R^3 mod p (9-16), p in 30-bit limbs (17-25) and
// p^-1 mod 2^30 (26).
struct InvConsts {
  Modulus M;
  uint32_t r3[WORDS];
  int32_t p30[LIMBS30];
  uint32_t p_inv30;
};

InvConsts inv_consts_from_host(const uint32_t* w) {
  InvConsts c;
  c.M = modulus_from_host(w);
  for (int k = 0; k < WORDS; ++k) c.r3[k] = w[WORDS + 1 + k];
  for (int k = 0; k < LIMBS30; ++k) c.p30[k] = static_cast<int32_t>(w[2 * WORDS + 1 + k]);
  c.p_inv30 = w[2 * WORDS + 1 + LIMBS30];
  return c;
}

// One column of the transition matrix of 30 divsteps, scaled by 2^30: (u, q)
// starts at (1, 0), (v, r) at (0, 1); entries in [-2^30, 2^30], run as
// uint32 (mod 2^32, which shifts left without overflow).
struct Col {
  uint32_t top, bot;
};

// Divstep i of a run of single steps, applied to zeta, f and g and to the
// column col.  fs and gs hold f and g times 2^i (mod 2^32): a step's g +- f
// is then the next step's gs without a shift, and bit i of gs is g's low
// bit.
__device__ __forceinline__ void divstep(int i, int32_t& zeta, uint32_t& fs, uint32_t& gs, Col& col) {
  const bool odd = (gs & (1u << i)) != 0;
  const bool swap = odd && zeta < 0;
  // odd: g + f, or g - f where swap (f takes the old g); even: g; then /2
  const uint32_t sum = gs + fs, diff = gs - fs;
  const uint32_t f_next = swap ? gs : fs;
  gs = swap ? diff : (odd ? sum : gs);
  fs = f_next << 1;
  zeta = swap ? -zeta - 2 : zeta - 1;
  // the column follows the same recurrence as (f, g)
  const uint32_t bsum = col.bot + col.top, bdiff = col.bot - col.top;
  const uint32_t t_next = swap ? col.bot : col.top;
  col.bot = swap ? bdiff : (odd ? bsum : col.bot);
  col.top = t_next << 1;
}

// The same 30 divsteps as JUMPS table jumps of JUMP steps, then single
// steps.  tab points at the entries of zeta class 0 (cuda_mul.inv_jump_table
// from its entry -ZLO << (2 JUMP - 1)): entry (zc << (2 JUMP - 1)) + ((f mod
// 2^JUMP) / 2 << JUMP) + g mod 2^JUMP, for zc = zeta clamped to [ZLO, ZHI],
// holds the JUMP steps' matrix M, scaled by 2^JUMP, and the new zeta as
// s zeta + c, as signed 16-bit halves: (M00, M01), (M10, M11), (s, c).  M
// maps (f, g) to 2^JUMP times the new (f, g), exactly, so the low bits that
// stay valid drop by JUMP a jump (30 - 28 = 2 for the last single steps),
// and a column to its new column.  The next index is taken from the
// products before their shift.
__device__ __forceinline__ int32_t divsteps_30_jumps(int32_t zeta, uint32_t f, uint32_t g, Col& col, const uint4* tab) {
  static_assert(JUMP == 4, "the index's masks are JUMP = 4's");
  uint32_t fg = ((f << 3) & 0x70u) | (g & 0xFu);
#pragma unroll
  for (int j = 0; j < JUMPS; ++j) {
    const int zc = min(max(zeta, ZLO), ZHI);
    const uint4 e = tab[zc * (1 << (2 * JUMP - 1)) + static_cast<int>(fg)];
    const uint32_t m00 = static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(e.x)));
    const uint32_t m01 = static_cast<uint32_t>(static_cast<int32_t>(e.x) >> 16);
    const uint32_t m10 = static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(e.y)));
    const uint32_t m11 = static_cast<uint32_t>(static_cast<int32_t>(e.y) >> 16);
    zeta = static_cast<int16_t>(e.z) * zeta + (static_cast<int32_t>(e.z) >> 16);
    const uint32_t pf = m00 * f + m01 * g, pg = m10 * f + m11 * g;  // 2^JUMP (f, g)
    f = pf >> JUMP;
    g = pg >> JUMP;
    fg = ((pf >> 1) & 0x70u) | (g & 0xFu);
    const uint32_t t = col.top, b = col.bot;
    col.top = m00 * t + m01 * b;
    col.bot = m10 * t + m11 * b;
  }
#pragma unroll
  for (int i = 0; i < STEPS - JUMP * JUMPS; ++i) divstep(i, zeta, f, g, col);
  return zeta;
}

// a x + b y + p m in 64 bits.  On the card the three products are opaque
// to the compiler, which would otherwise fold them into the running carry
// of update_row, one chain through every product of every limb.
__device__ __forceinline__ int64_t dot3(int32_t a, int32_t x, int32_t b, int32_t y, int32_t p, int32_t m) {
#ifdef __CUDA_ARCH__
  int64_t r;
  asm("mul.wide.s32 %0, %1, %2;\n\t"
      "mad.wide.s32 %0, %3, %4, %0;\n\t"
      "mad.wide.s32 %0, %5, %6, %0;"
      : "=l"(r)
      : "r"(a), "r"(x), "r"(b), "r"(y), "r"(p), "r"(m));
  return r;
#else
  return static_cast<int64_t>(a) * x + static_cast<int64_t>(b) * y + static_cast<int64_t>(p) * m;
#endif
}

// One row of t / 2^30, a group lane's: own <- (a own + b oth + p m) / 2^30,
// with (own, oth) = (d, e), a = u, b = v for row 0 and (e, d), r, q for row
// 1 (likewise (f, g)).  With pmask all ones ((d, e)) m is the multiple of p
// that clears the low 30 bits, chosen from the signs so that d and e stay in
// (-2p, p), their limbs below 2^30; with pmask 0 ((f, g)) the division is
// exact.  Each limb's three products are summed apart from the carry, which
// then takes one 64-bit add and shift a limb.
__device__ __forceinline__ void update_row(int32_t own[LIMBS30], const int32_t oth[LIMBS30], int32_t a, int32_t b,
                                           int32_t pmask, const InvConsts& C) {
  int32_t m = (a & (own[LIMBS30 - 1] >> 31)) + (b & (oth[LIMBS30 - 1] >> 31));
  const int64_t c0 = static_cast<int64_t>(a) * own[0] + static_cast<int64_t>(b) * oth[0];
  m -= static_cast<int32_t>((C.p_inv30 * static_cast<uint32_t>(c0) + static_cast<uint32_t>(m)) & M30);
  m &= pmask;
  int64_t c = (c0 + static_cast<int64_t>(C.p30[0]) * m) >> 30;
#pragma unroll
  for (int i = 1; i < LIMBS30; ++i) {
    c += dot3(a, own[i], b, oth[i], C.p30[i], m);
    own[i - 1] = static_cast<int32_t>(static_cast<uint32_t>(c) & M30);
    c >>= 30;
  }
  own[LIMBS30 - 1] = static_cast<int32_t>(c);
}

// Limbs below 2^30 again, the carries into the top limb.
__device__ __forceinline__ void propagate(int32_t d[LIMBS30]) {
#pragma unroll
  for (int i = 0; i < LIMBS30 - 1; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] = static_cast<int32_t>(static_cast<uint32_t>(d[i]) & M30);
  }
}

// d in (-2p, p) -> d mod p in [0, p), negated first where sign < 0 (f = -1).
__device__ __forceinline__ void normalize(int32_t d[LIMBS30], int32_t sign, const InvConsts& C) {
  int32_t add = d[LIMBS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) d[i] += C.p30[i] & add;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) d[i] = (d[i] ^ neg) - neg;
  propagate(d);
  add = d[LIMBS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) d[i] += C.p30[i] & add;
  propagate(d);
}

// Element idx of a (16, m) array as 9 30-bit limbs (limb i: bits 30 i ..
// 30 i + 29).
__device__ __forceinline__ void load_limbs30(const uint32_t* __restrict__ a, int m, size_t idx,
                                             int32_t x[LIMBS30]) {
  uint32_t w[WORDS + 1];
  load_elem(a, m, idx, w);
  w[WORDS] = 0;
#pragma unroll
  for (int i = 0; i < LIMBS30; ++i) {
    const int lo = 30 * i / 32, sh = 30 * i % 32;
    const uint64_t pair = w[lo] | static_cast<uint64_t>(w[lo + 1]) << 32;
    x[i] = static_cast<int32_t>(static_cast<uint32_t>(pair >> sh) & M30);
  }
}

// d = +-x^-1 in (-2p, p) -> a^-1 R into element idx of out.
template <class A>
__device__ __forceinline__ void finish(int32_t d[LIMBS30], int32_t fsign, const InvConsts& C, uint32_t* __restrict__ out,
                                       int m, size_t idx) {
  normalize(d, fsign, C);
  uint32_t w[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {  // word k: bits 32 k .. 32 k + 31, from limbs lo and lo + 1
    const int lo = 32 * k / 30, sh = 32 * k % 30;
    const uint64_t pair =
        static_cast<uint32_t>(d[lo]) | static_cast<uint64_t>(static_cast<uint32_t>(d[lo + 1])) << 30;
    w[k] = static_cast<uint32_t>(pair >> sh);
  }
  uint32_t res[WORDS];
  A::mul(w, C.r3, C.M, res);
  store_elem(out, m, idx, res);
}

// G lanes an element (G = 2 or 4; 128 % G == 0, so a group never spans two
// warps).  Lane r of a group: row r & 1; at G = 2 it holds (d, e) and (f, g)
// (vector 0 and 1), at G = 4 one of them, (d, e) for r < 2.  own[v] is the
// row's vector of the pair (d or f for row 0, e or g for row 1), oth[v] the
// other.  A warp whose first element is past m returns whole; in the others
// a lane past m works on element m - 1 and stores nothing, so every shuffle
// has all 32 lanes.
template <class A, int G>
__global__ void __launch_bounds__(INV_THREADS)
mont_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int m, InvConsts C,
                const uint4* __restrict__ jump_table) {
  constexpr int V = G == 2 ? 2 : 1;
  __shared__ uint4 tab[JUMP_TABLE];
  for (int k = threadIdx.x; k < JUMP_TABLE; k += blockDim.x) tab[k] = jump_table[k];
  __syncthreads();
  const uint4* tab0 = tab - ZLO * (1 << (2 * JUMP - 1));  // zeta class 0's entries
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((tid & ~static_cast<size_t>(31)) / G >= static_cast<size_t>(m)) return;
  const size_t elem = tid / G;
  const size_t idx = elem < static_cast<size_t>(m) ? elem : static_cast<size_t>(m) - 1;
  const int r = static_cast<int>(threadIdx.x % G);
  const bool row1 = r & 1;
  int32_t x[LIMBS30];
  load_limbs30(a, m, idx, x);
  int32_t own[V][LIMBS30], oth[V][LIMBS30];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool fg = G == 2 ? v == 1 : r >= 2;
#pragma unroll
    for (int i = 0; i < LIMBS30; ++i) {
      const int32_t lo = fg ? C.p30[i] : 0, hi = fg ? x[i] : i == 0;  // (f, g) or (d, e)
      own[v][i] = row1 ? hi : lo;
      oth[v][i] = row1 ? lo : hi;
    }
  }
  int32_t zeta = -1;
#pragma unroll 2
  for (int b = 0; b < BATCHES; ++b) {
    uint32_t f0, g0;
    if (G == 2) {
      f0 = static_cast<uint32_t>(row1 ? oth[V - 1][0] : own[V - 1][0]);
      g0 = static_cast<uint32_t>(row1 ? own[V - 1][0] : oth[V - 1][0]);
    } else {  // lane 2 of the group: own = f, oth = g
      f0 = static_cast<uint32_t>(__shfl_sync(FULL_WARP, own[0][0], 2, G));
      g0 = static_cast<uint32_t>(__shfl_sync(FULL_WARP, oth[0][0], 2, G));
    }
    Col col = {row1 ? 0u : 1u, row1 ? 1u : 0u};  // this lane's column: (u, q) or (v, r)
    zeta = divsteps_30_jumps(zeta, f0, g0, col, tab0);
    // row 0 takes (u, v), row 1 (r, q): its own column's entry of its row,
    // and the partner's, which the partner sends
    const int32_t a_row = static_cast<int32_t>(row1 ? col.bot : col.top);
    const uint32_t send = row1 ? col.top : col.bot;
    const int32_t b_row = static_cast<int32_t>(__shfl_xor_sync(FULL_WARP, send, 1));
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool fg = G == 2 ? v == 1 : r >= 2;
      update_row(own[v], oth[v], a_row, b_row, fg ? 0 : -1, C);
#pragma unroll
      for (int i = 0; i < LIMBS30; ++i) oth[v][i] = __shfl_xor_sync(FULL_WARP, own[v][i], 1);
    }
  }
  // f's top limb (its sign) from the row-0 (f, g) lane; d is lane 0's own[0]
  const int32_t fsign = G == 2 ? (row1 ? oth[V - 1][LIMBS30 - 1] : own[V - 1][LIMBS30 - 1])
                               : __shfl_sync(FULL_WARP, own[0][LIMBS30 - 1], 2, G);
  if (r == 0 && elem < static_cast<size_t>(m)) finish<A>(own[0], fsign, C, out, m, idx);
}

template <class A>
int launch_inv(const uint32_t* x, uint32_t* o, int m, const InvConsts& C, int group, const uint4* table,
               cudaStream_t s) {
  const size_t threads = static_cast<size_t>(m) * group;
  const unsigned blocks = static_cast<unsigned>((threads + INV_THREADS - 1) / INV_THREADS);
  if (group == 2) {
    mont_inv_kernel<A, 2><<<blocks, INV_THREADS, 0, s>>>(x, o, m, C, table);
  } else if (group == 4) {
    mont_inv_kernel<A, 4><<<blocks, INV_THREADS, 0, s>>>(x, o, m, C, table);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = a^-1 (Montgomery in and out) for the m elements of a (16, m) array;
// consts: the 27 words of InvConsts; arith 0: carry chains (p < 2^254), 1:
// 64-bit accumulators; group: G, the lanes an element (2 or 4); table: the
// JUMP_TABLE 16-byte entries of cuda_mul.inv_jump_table on the device.
extern "C" int h2t_mont_inv(const void* a, void* out, int m, const void* consts, int arith, int group,
                            const void* table, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const InvConsts C = inv_consts_from_host(static_cast<const uint32_t*>(consts));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* t = static_cast<const uint4*>(table);
  auto* o = static_cast<uint32_t*>(out);
  if (arith == 0) return launch_inv<CcArith>(x, o, m, C, group, t, s);
  if (arith == 1) return launch_inv<WideArith>(x, o, m, C, group, t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

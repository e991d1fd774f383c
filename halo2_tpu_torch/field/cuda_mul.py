"""Batched Montgomery multiply, square, power and inverse: the CUDA kernels,
their plain PyTorch versions, and the wrappers that pick one by the
tensors' device.

The kernels (``csrc/mont_mul.cu``) replace
``halo2_tpu/field/pallas_mul.py:_mont_mul_kernel`` and ``_mont_sqr_kernel``,
and (``mont_pow``, a whole square-and-multiply ladder in one launch) the
reference's ``lax.scan`` power, ``halo2_tpu/field/device.py:239-253``;
``mont_inv`` (``csrc/inv.cu``, a fixed-count safegcd in one launch)
replaces its Fermat ``inv`` (``:251``).
:func:`mont_mul_columns` multiplies a ``(C, 16, n)`` batch of columns by a
full-width, shared or periodic b in one launch, as the reference's
``mont_mul`` takes any batch shape in one call.
Field arrays are ``(16, *batch)`` int32 tensors of 16-bit limbs, Montgomery
form, canonical (< p): the reference's ``uint32`` numbers held in int32.

:func:`mont_mul_columns` (:func:`mont_sqr`, :func:`mont_pow`, :func:`mont_inv`) runs
:func:`mont_mul_columns_plain` (:func:`mont_sqr_plain`, :func:`mont_pow_plain`,
:func:`mont_inv_plain`) for
a CPU tensor and launches the kernel for a CUDA tensor; there is no
fallback between the two.  ``LAUNCHES`` counts kernel launches by name.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, FieldSpec, to_limbs

L = NUM_LIMBS
LAUNCHES = {"mont_mul": 0, "mont_sqr": 0, "mont_pow": 0, "mont_inv": 0}
# the kernels' arithmetic, as the C entry points number it
ARITH = {"cc": 0, "wide": 1}


def arith(spec: FieldSpec) -> str:
    """``"cc"`` (``csrc/field_cc.cuh``'s carry chains, whose bounds hold for
    p < 2^254) or ``"wide"`` (``csrc/field.cuh``'s 64-bit accumulators)."""
    return "cc" if spec.p.bit_length() <= 254 else "wide"


@functools.lru_cache(maxsize=None)
def modulus_words(spec: FieldSpec) -> np.ndarray:
    """(9,) uint32 kernel argument: p as 8 little-endian words, then
    n0 = -p^{-1} mod 2^32."""
    words = [(spec.p >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    words.append((-pow(spec.p, -1, 1 << 32)) % (1 << 32))
    return np.array(words, np.uint32)


@functools.lru_cache(maxsize=None)
def modulus_one_words(spec: FieldSpec) -> np.ndarray:
    """(17,) uint32 kernel argument: :func:`modulus_words`, then the
    Montgomery one R mod p as 8 little-endian words."""
    one = to_limbs(spec.r)
    words = [one[2 * k] | (one[2 * k + 1] << LIMB_BITS) for k in range(8)]
    return np.concatenate([modulus_words(spec), np.array(words, np.uint32)])


# ------------------------------------------------------------- plain version
_ROW_CARRY_MIN = 1 << 11  # elements a limb row from which carry() goes row by row on the CPU


def carry(t: torch.Tensor):
    """Carry-propagate int64 limb columns ``(nl, *B)`` (any sign) into
    16-bit limbs; returns ``(limbs, carry_out)``, carry_out < 0 on a borrow.
    Every row passes its carry up at once, until no row has one: a few
    passes of whole-tensor ops (a ripple through limbs of 0xFFFF takes one
    more pass a limb) instead of one pass a row, which at the narrow widths
    of a curve's Horner tail is what the plain versions' time goes to.  On
    CPU tensors of ``_ROW_CARRY_MIN`` elements a row or more, one pass a
    row: there the passes' whole-tensor memory traffic costs more than the
    ops (on the card every op is a launch, and the passes stay)."""
    if t.device.type == "cpu" and t[0].numel() >= _ROW_CARRY_MIN:
        out = torch.empty_like(t)
        c = torch.zeros_like(t[0])
        for r in range(t.shape[0]):
            v = t[r] + c
            out[r] = v & LIMB_MASK
            c = v >> LIMB_BITS
        return out, c
    c = torch.zeros_like(t[0])
    while True:
        hi = t >> LIMB_BITS
        if not bool(hi.any()):
            return t, c
        t = t & LIMB_MASK
        c = c + hi[-1]
        t[1:] += hi[:-1]


@functools.lru_cache(maxsize=None)
def _plain_consts(spec: FieldSpec, device: torch.device):
    """p as an int64 (16, 1) column, and the Toeplitz matrices (float64) whose
    product with a limb column gives the column sums of x * N' mod R and of
    x * p (N' = -p^{-1} mod R).  Every sum is below 16 * 2^32 < 2^53, so the
    float64 products are exact."""
    nprime = (-pow(spec.p, -1, 1 << 256)) % (1 << 256)
    n_l = [(nprime >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)]
    p_l = [(spec.p >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)]
    t_n = np.zeros((L, L), np.float64)
    t_p = np.zeros((2 * L, L), np.float64)
    for i in range(L):
        for j in range(L):
            if i + j < L:
                t_n[i + j, i] = n_l[j]
            t_p[i + j, i] = p_l[j]
    p_col = torch.tensor(p_l, dtype=torch.int64, device=device).reshape(L, 1)
    return (
        p_col,
        torch.from_numpy(t_n).to(device),
        torch.from_numpy(t_p).to(device),
    )


def _redc_plain(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """int64 product columns ``(2L, m)`` of T < p * R -> T * R^-1 mod p as
    int32 limbs: m = (T mod R) * N' mod R, (T + m p) / R, one conditional
    subtract."""
    p_col, t_n, t_p = _plain_consts(spec, t.device)
    t_low, _ = carry(t[:L])  # T mod R
    m, _ = carry((t_n @ t_low.double()).to(torch.int64))
    s, _ = carry(t + (t_p @ m.double()).to(torch.int64))  # low half is zero
    res = s[L:]  # (T + m p) / R < 2p
    red, borrow = carry(res - p_col)
    return torch.where(borrow < 0, res, red).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _terms(square: bool, device: torch.device) -> tuple:
    """The limb products a_i b_j of a schoolbook product, as index tensors
    ``(i, j, column i + j, weight)``: all 256 for a product; for a square
    the 136 of the upper triangle (i <= j), the off-diagonal ones weighted
    2, as the kernel forms them."""
    i, j = torch.meshgrid(torch.arange(L), torch.arange(L), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    if square:
        keep = i <= j
        i, j = i[keep], j[keep]
    w = torch.where(i == j, 1, 2) if square else torch.ones_like(i)
    return tuple(v.to(device) for v in (i, j, i + j, w))


_PRODUCT_CHUNK = 1 << 16  # columns a pass: up to 256 int64 products each, 128 MB
_GATHER_MAX = 128  # CPU columns up to which _product_columns gathers every limb product


def _product_columns(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """int64 limbs ``(L, m)`` -> the ``(2L, m)`` column sums of the
    schoolbook product a * b, or of the square a * a when ``b`` is None
    (each sum < 16 * 2^32): every limb product of a chunk of columns at
    once, summed into its column by one ``index_add_`` (exact in int64), in
    few ops.  On CPU tensors of more than ``_GATHER_MAX`` columns, a_i times
    all of b added into rows i .. i + 15, one op pair a limb of a, which
    moves 16 times less memory than the gathered products (on the card
    every op is a launch, and the gather stays)."""
    t = a.new_zeros((2 * L, a.shape[1]))
    if a.device.type == "cpu" and a.shape[1] > _GATHER_MAX:
        b = a if b is None else b
        for i in range(L):
            t[i:i + L] += a[i] * b
        return t
    i, j, col, w = _terms(b is None, a.device)
    b = a if b is None else b
    for lo in range(0, a.shape[1], _PRODUCT_CHUNK):
        hi = lo + _PRODUCT_CHUNK
        t[:, lo:hi].index_add_(0, col, a[i, lo:hi] * b[j, lo:hi] * w[:, None])
    return t


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p in int64 torch ops (the reference's loop-free
    algorithm): T = a * b, then :func:`_redc_plain`.  a, b broadcast over
    their batch axes."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    t = _product_columns(a.reshape(L, -1).to(torch.int64), b.reshape(L, -1).to(torch.int64))
    return _redc_plain(spec, t).reshape(shape)


def mont_sqr_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a * a * 2^-256 mod p in int64 torch ops: T from the 136 limb products
    of the upper triangle (off-diagonal ones doubled; from all 256 on CPU
    tensors above ``_GATHER_MAX`` elements), then :func:`_redc_plain`; equal to
    ``mont_mul_plain(spec, a, a)``."""
    shape = a.shape
    return _redc_plain(spec, _product_columns(a.reshape(L, -1).to(torch.int64), None)).reshape(shape)


def mont_pow_plain(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-known exponent e >= 0 in int64 torch ops: square and
    multiply over e's bits, LSB first, the multiply skipped where a bit is 0
    (the reference multiplies by one there, which gives the same limbs: a
    Montgomery product with R mod p is the identity); a^0 = one, 0^e = 0."""
    acc, base = None, a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            acc = base if acc is None else mont_mul_plain(spec, acc, base)
        if i + 1 < e.bit_length():
            base = mont_sqr_plain(spec, base)
    if acc is None:
        one = torch.tensor(to_limbs(spec.r), dtype=torch.int32, device=a.device)
        return one.reshape((L,) + (1,) * (a.dim() - 1)).expand(a.shape).contiguous()
    return acc.clone() if acc is a else acc


# --------------------------------------------------------------------- wrapper
def check_limbs(op: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 ``(16, ...)`` limb
    array, all on one device."""
    devices = set()
    for name, x in tensors.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{op}: {name} must be int32, got {x.dtype}")
        if x.dim() < 1 or x.shape[0] != L:
            raise ValueError(f"{op}: {name} must be (16, ...), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        devices.add(x.device)
    if len(devices) > 1:
        raise ValueError(f"{op}: tensors on several devices {sorted(map(str, devices))}")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    check_limbs("mont_mul", a=a, b=b)
    if b.shape != a.shape and b.numel() != L:
        raise ValueError(
            f"mont_mul: b must match a {tuple(a.shape)} or be one element, got {tuple(b.shape)}"
        )


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of ``(16, *batch)`` a and b (b full width, or one
    broadcast element): :func:`mont_mul_columns` over the flat ``(16, m)``
    form.  CPU tensors: plain version; CUDA tensors: one kernel launch."""
    _check(a, b)
    flat, b = a.reshape(L, -1), b.reshape(L, -1)
    if a.device.type == "cpu":
        return mont_mul_columns_plain(spec, flat, b).reshape(a.shape)
    return _launch(spec, flat, b, torch.empty_like(a)).reshape(a.shape)


def _columns(a: torch.Tensor) -> tuple[int, int]:
    """(C, n) of a ``(16, n)`` or ``(C, 16, n)`` column batch."""
    return (1 if a.dim() == 2 else a.shape[0]), a.shape[-1]


def _check_columns(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless a is a ``(16, n)`` or ``(C, 16, n)`` int32 batch whose
    columns are each contiguous, and b is a's shape (each column
    contiguous) or a contiguous ``(16, P)`` with P dividing n."""
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.int32:
            raise TypeError(f"mont_mul: {name} must be int32, got {x.dtype}")
    if a.dim() not in (2, 3) or a.shape[-2] != L:
        raise ValueError(f"mont_mul: a must be (16, n) or (C, 16, n), got {tuple(a.shape)}")
    n = a.shape[-1]
    if a.stride()[-2:] != (n, 1) and a.numel():
        raise ValueError("mont_mul: each column of a must be contiguous")
    if b.shape == a.shape:
        if b.stride()[-2:] != (n, 1) and b.numel():
            raise ValueError("mont_mul: each column of b must be contiguous")
    elif b.dim() != 2 or b.shape[0] != L or b.shape[1] == 0 or n % b.shape[1] or not b.is_contiguous():
        raise ValueError(
            f"mont_mul: b must match a {tuple(a.shape)} or be a contiguous (16, P) with P dividing {n}, "
            f"got {tuple(b.shape)}"
        )
    if a.device != b.device:
        raise ValueError(f"mont_mul: a on {a.device}, b on {b.device}")


def mont_mul_columns_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`mont_mul_columns` in int64 torch ops: b tiled to full width,
    then :func:`mont_mul_plain` over every column at once."""
    cols, n = _columns(a)
    b_cols = cols if b.shape == a.shape else 1
    if b.shape != a.shape:
        b = b.repeat(1, n // b.shape[1])  # (16, n): element j meets b[:, j mod P]
    a3 = a.reshape(cols, L, n).permute(1, 0, 2)
    b3 = b.reshape(b_cols, L, n).permute(1, 0, 2)
    return mont_mul_plain(spec, a3, b3).permute(1, 0, 2).reshape(a.shape).contiguous()


def mont_mul_columns(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of every column of a ``(16, n)`` or ``(C, 16, n)``
    batch a (each column contiguous, any column stride) with b: full width
    (a's shape), or a contiguous ``(16, P)``, P dividing n, that every column
    shares, element j meeting ``b[:, j mod P]`` (P = n: one (16, n) for all
    columns; P = 1: one element; P = m: a stage ladder's twiddles).  Returns
    a contiguous tensor of a's shape.  CPU tensors: the plain version; CUDA
    tensors: one kernel launch for all C columns."""
    _check_columns(a, b)
    if a.device.type == "cpu":
        return mont_mul_columns_plain(spec, a, b)
    return _launch(spec, a, b, torch.empty(a.shape, dtype=a.dtype, device=a.device))


def _launch(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """One ``mont_mul`` launch of a checked column batch (a and b as
    :func:`mont_mul_columns` takes them) into a contiguous ``out`` of a's
    shape."""
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul: unsupported device {a.device}")
    from .. import _build

    cols, n = _columns(a)
    if n == 0 or cols == 0:
        return out
    a_cs = a.stride(0) if a.dim() == 3 else L * n
    full = b.shape == a.shape
    b_cs = (b.stride(0) if b.dim() == 3 else L * n) if full else 0
    period = n if full else b.shape[1]
    # four elements a thread (16-byte loads) need n % 4 == 0 and aligned columns
    vec = n % 4 == 0 and a.data_ptr() % 16 == 0 and a_cs % 4 == 0 and out.data_ptr() % 16 == 0
    bvec = vec and period % 4 == 0 and b.data_ptr() % 16 == 0 and b_cs % 4 == 0
    _build.launch(
        "mont_mul", a.device, a.data_ptr(), a_cs, b.data_ptr(), b_cs, period, out.data_ptr(), n, cols,
        int(vec), int(bvec), ARITH[arith(spec)], modulus_words(spec).ctypes.data,
    )
    LAUNCHES["mont_mul"] += 1
    return out


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery square of ``(16, *batch)`` a.  CPU tensors: plain version;
    CUDA tensors: kernel."""
    check_limbs("mont_sqr", a=a)
    if a.device.type == "cpu":
        return mont_sqr_plain(spec, a)
    if a.device.type != "cuda":
        raise ValueError(f"mont_sqr: unsupported device {a.device}")
    from .. import _build

    out = torch.empty_like(a)
    m = a.numel() // L
    if m == 0:
        return out
    _build.launch("mont_sqr", a.device, a.data_ptr(), out.data_ptr(), m, modulus_words(spec).ctypes.data)
    LAUNCHES["mont_sqr"] += 1
    return out


@functools.lru_cache(maxsize=64)
def _exponent_words(e: int, device: torch.device) -> torch.Tensor:
    """e as 32-bit words, least significant first (at least one), in an
    int32 tensor on ``device``: made once per exponent and device, so a
    :func:`mont_pow` call copies nothing from host to device."""
    words = [(e >> (32 * k)) & 0xFFFFFFFF for k in range(max(1, -(-e.bit_length() // 32)))]
    return torch.from_numpy(np.array(words, np.uint32).view(np.int32)).to(device)


def mont_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise over ``(16, *batch)`` a, for a host-known exponent
    e >= 0 of any length (inv: e = p - 2).  CPU tensors: plain version;
    CUDA tensors: the ``mont_pow`` kernel, the whole ladder in one launch."""
    check_limbs("mont_pow", a=a)
    if e < 0:
        raise ValueError(f"mont_pow: the exponent must be >= 0, got {e}")
    if a.device.type == "cpu":
        return mont_pow_plain(spec, a, e)
    if a.device.type != "cuda":
        raise ValueError(f"mont_pow: unsupported device {a.device}")
    from .. import _build

    out = torch.empty_like(a)
    m = a.numel() // L
    if m == 0:
        return out
    _build.launch(
        "mont_pow", a.device, a.data_ptr(), out.data_ptr(), m, _exponent_words(e, a.device).data_ptr(),
        e.bit_length(), modulus_one_words(spec).ctypes.data, ARITH[arith(spec)],
    )
    LAUNCHES["mont_pow"] += 1
    return out


# ------------------------------------------------------------------ inverse
# the safegcd's shape (csrc/inv.cu): 9 signed 30-bit limbs a value, 20
# batches of 30 divsteps (600: libsecp256k1's modinv32 count; 590 suffice
# for every input below 2^256)
INV_LIMBS, INV_BATCHES, INV_STEPS = 9, 20, 30
_M30, _M32 = (1 << 30) - 1, (1 << 32) - 1
# the kernel's schedules, G = 2 or 4 lanes of a warp an element
# (csrc/inv.cu); inv_plan's rule, (most elements, G), measured on one H100
# with scripts/inv_probe.py's sweep (PERF.md): G = 4 up to 2^12 elements, G = 2
# above (faster at 2^13-2^20 than G = 4 and than one thread an element)
INV_GROUPS = (2, 4)
INV_PLAN = ((1 << 12, 4),)
INV_PLAN_ABOVE = 2
# the kernel's jumps: a table lookup applies INV_JUMP divsteps at once
# (INV_JUMPS of them a batch, then INV_STEPS - INV_JUMP INV_JUMPS single
# divsteps).  The INV_JUMP steps from (zeta, f, g) depend on f and g mod
# 2^INV_JUMP and on zeta only through zeta clamped to INV_ZETA_CLAMP (the
# clamp that keeps every path, found by trying every zeta in [-60, 60]).
INV_JUMP, INV_JUMPS = 4, 7
INV_ZETA_CLAMP = (-4, 3)


def _divsteps_path(zeta: int, f: int, g: int, steps: int) -> tuple:
    """``steps`` divsteps from zeta on the integers f (odd) and g, as the
    kernel takes them (halving g exactly); returns ((zeta scale s, zeta
    offset c), M): the new zeta is s zeta + c, and M, the 2x2 matrix of
    the steps scaled by 2^steps, maps (f, g) to 2^steps times the new
    (f, g) and a matrix column of the batch to its new column."""
    s, c = 1, 0
    m = [[1, 0], [0, 1]]
    for _ in range(steps):
        odd, swap = g & 1, (g & 1) and zeta < 0
        if swap:
            zeta, f, g = -zeta - 2, g, (g - f) >> 1
            s, c = -s, -c - 2
        else:
            zeta, g = zeta - 1, ((g + f) if odd else g) >> 1
            c -= 1
        step = [[0, 2], [-1, 1]] if swap else [[2, 0], [odd, 1]]
        m = [[sum(step[r][k] * m[k][col] for k in range(2)) for col in range(2)] for r in range(2)]
    return (s, c), m


@functools.lru_cache(maxsize=None)
def inv_jump_table() -> np.ndarray:
    """``(classes x 2^(INV_JUMP - 1) x 2^INV_JUMP, 4)`` uint32, the
    ``mont_inv`` kernel's table: entry ``((zc - lo) 2^(INV_JUMP - 1) + (f mod
    2^INV_JUMP) // 2) 2^INV_JUMP + g mod 2^INV_JUMP``, for zc = zeta
    clamped to ``INV_ZETA_CLAMP = (lo, hi)``, holds :func:`_divsteps_path`
    of INV_JUMP steps as signed 16-bit halves, the low one first: (M00,
    M01), (M10, M11), (s, c), then a zero word (16 bytes an entry, one
    128-bit load)."""
    lo, hi = INV_ZETA_CLAMP
    half, full = 1 << (INV_JUMP - 1), 1 << INV_JUMP
    table = np.zeros(((hi - lo + 1) * half * full, 4), np.uint32)
    for zc in range(lo, hi + 1):
        for fb in range(half):
            for g in range(full):
                (s, c), m = _divsteps_path(zc, 2 * fb + 1, g, INV_JUMP)
                i = ((zc - lo) * half + fb) * full + g
                for w, (x, y) in enumerate(((m[0][0], m[0][1]), (m[1][0], m[1][1]), (s, c))):
                    table[i, w] = (x & 0xFFFF) | ((y & 0xFFFF) << 16)
    return table


@functools.lru_cache(maxsize=None)
def _jump_table_device(device: torch.device) -> torch.Tensor:
    """:func:`inv_jump_table` on ``device``, made once per device."""
    return torch.from_numpy(inv_jump_table().view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def inv_consts(spec: FieldSpec) -> tuple:
    """(p in 30-bit limbs, p^-1 mod 2^30, R^3 mod p): the inverse's
    constants (R = 2^256)."""
    p = spec.p
    return tuple((p >> (30 * i)) & _M30 for i in range(INV_LIMBS)), pow(p, -1, 1 << 30), pow(1 << 256, 3, p)


@functools.lru_cache(maxsize=None)
def inv_words(spec: FieldSpec) -> np.ndarray:
    """(27,) uint32 kernel argument of ``mont_inv``: :func:`modulus_words`,
    R^3 mod p as 8 little-endian words, p in 30-bit limbs, p^-1 mod 2^30."""
    p30, p_inv30, r3 = inv_consts(spec)
    r3_words = [(r3 >> (32 * k)) & _M32 for k in range(8)]
    return np.concatenate([modulus_words(spec), np.array([*r3_words, *p30, p_inv30], np.uint32)])


def _divsteps_30(zeta, f, g):
    """30 divsteps over the low limbs f (odd) and g of every element, as
    csrc/inv.cu's divsteps_30 takes them (f and g mod 2^32; u, v, q, r exact,
    within [-2^30, 2^30]); returns zeta and the matrix (u, v, q, r)."""
    u, r = torch.ones_like(f), torch.ones_like(f)
    v, q = torch.zeros_like(f), torch.zeros_like(f)
    for _ in range(INV_STEPS):
        c1 = zeta >> 63  # -1 where zeta < 0
        c2 = -(g & 1)  # -1 where g is odd
        x, y, z = ((f ^ c1) - c1) & _M32, (u ^ c1) - c1, (v ^ c1) - c1
        g = (g + (x & c2)) & _M32
        q = q + (y & c2)
        r = r + (z & c2)
        c3 = c1 & c2
        zeta = (zeta ^ c3) - 1
        f = (f + (g & c3)) & _M32
        u = u + (q & c3)
        v = v + (r & c3)
        g = g >> 1
        u = u * 2
        v = v * 2
    return zeta, (u, v, q, r)


def _update_de(d, e, t, p30, p_inv30):
    """(d, e) <- t (d, e) / 2^30 mod p over ``(9, m)`` int64 limbs (inv.cu's
    update_de)."""
    u, v, q, r = t
    sd, se = d[-1] >> 63, e[-1] >> 63
    md = (u & sd) + (v & se)
    me = (q & sd) + (r & se)
    cd = u * d[0] + v * e[0]
    ce = q * d[0] + r * e[0]
    md = md - ((p_inv30 * (cd & _M30) + md) & _M30)
    me = me - ((p_inv30 * (ce & _M30) + me) & _M30)
    cd = (cd + p30[0] * md) >> 30
    ce = (ce + p30[0] * me) >> 30
    nd, ne = [], []
    for i in range(1, INV_LIMBS):
        cd = cd + u * d[i] + v * e[i] + p30[i] * md
        ce = ce + q * d[i] + r * e[i] + p30[i] * me
        nd.append(cd & _M30)
        ne.append(ce & _M30)
        cd, ce = cd >> 30, ce >> 30
    return torch.stack(nd + [cd]), torch.stack(ne + [ce])


def _update_fg(f, g, t):
    """(f, g) <- t (f, g) / 2^30, exact (inv.cu's update_fg)."""
    u, v, q, r = t
    cf = (u * f[0] + v * g[0]) >> 30
    cg = (q * f[0] + r * g[0]) >> 30
    nf, ng = [], []
    for i in range(1, INV_LIMBS):
        cf = cf + u * f[i] + v * g[i]
        cg = cg + q * f[i] + r * g[i]
        nf.append(cf & _M30)
        ng.append(cg & _M30)
        cf, cg = cf >> 30, cg >> 30
    return torch.stack(nf + [cf]), torch.stack(ng + [cg])


def _propagate(d: torch.Tensor) -> torch.Tensor:
    rows = list(d)
    for i in range(INV_LIMBS - 1):
        rows[i + 1] = rows[i + 1] + (rows[i] >> 30)
        rows[i] = rows[i] & _M30
    return torch.stack(rows)


def _normalize(d, sign, p30_col):
    """d in (-2p, p) -> d mod p in [0, p), negated first where sign < 0."""
    d = d + (p30_col & (d[-1] >> 63))
    neg = sign >> 63
    d = _propagate((d ^ neg) - neg)
    return _propagate(d + (p30_col & (d[-1] >> 63)))


def mont_inv_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 for Montgomery ``(16, *batch)`` a, inv(0) = 0, in int64 torch
    ops: the ``mont_inv`` kernel's safegcd step for step (the same 30-bit
    limbs, INV_BATCHES batches of INV_STEPS divsteps), then the Montgomery
    product by R^3 mod p that turns x^-1 = (a R)^-1 into a^-1 R."""
    p30, p_inv30, r3 = inv_consts(spec)
    shape = a.shape
    x = a.reshape(L, -1).to(torch.int64)
    words = torch.cat([x[0::2] | (x[1::2] << LIMB_BITS), torch.zeros_like(x[:1])])  # (9, m), the last 0
    # limb i: bits 30 i .. 30 i + 29, from words 30 i // 32 and the next (< 2^60 of it)
    g = torch.stack([((words[30 * i // 32] | ((words[30 * i // 32 + 1] & 0xFFFFFFF) << 32)) >> (30 * i % 32)) & _M30
                     for i in range(INV_LIMBS)])
    p30_col = torch.tensor(p30, dtype=torch.int64, device=a.device).reshape(INV_LIMBS, 1)
    f = p30_col.expand(g.shape)
    d = torch.zeros_like(g)
    e = torch.zeros_like(g)
    e[0] = 1
    zeta = torch.full_like(g[0], -1)
    for _ in range(INV_BATCHES):
        zeta, t = _divsteps_30(zeta, f[0], g[0])
        d, e = _update_de(d, e, t, p30, p_inv30)
        f, g = _update_fg(f, g, t)
    d = torch.cat([_normalize(d, f[-1], p30_col), torch.zeros_like(d[:1])])  # [0, p), a zero limb above
    # 16-bit limb j: bits 16 j .. 16 j + 15, from limbs 16 j // 30 and the next
    limbs = torch.stack([((d[16 * j // 30] | (d[16 * j // 30 + 1] << 30)) >> (16 * j % 30)) & LIMB_MASK
                         for j in range(L)])
    r3_col = torch.tensor(to_limbs(r3), dtype=torch.int32, device=a.device).reshape(L, 1)
    return mont_mul_plain(spec, limbs.to(torch.int32), r3_col).reshape(shape)


def inv_plan(m: int) -> int:
    """G, the lanes of a warp an element of the ``mont_inv`` kernel, for a
    call over ``m`` elements: the first of ``INV_PLAN`` whose most elements
    m does not exceed, else ``INV_PLAN_ABOVE``."""
    return next((group for most, group in INV_PLAN if m <= most), INV_PLAN_ABOVE)


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 elementwise over Montgomery ``(16, *batch)`` a, inv(0) = 0 (the
    reference's ``DeviceField.inv``).  CPU tensors: :func:`mont_inv_plain`;
    CUDA tensors: the ``mont_inv`` kernel (a fixed-count safegcd, one
    launch) with the G lanes an element :func:`inv_plan` picks."""
    return _mont_inv(spec, a)


def _mont_inv(spec: FieldSpec, a: torch.Tensor, group: int | None = None) -> torch.Tensor:
    """:func:`mont_inv` with G = ``group`` lanes an element, one of
    ``INV_GROUPS`` (None: :func:`inv_plan`'s); the tests and
    ``chip_smoke.py`` force each one.  Every G gives the same limbs, so a
    CPU tensor takes the plain version whatever G."""
    if group is not None and group not in INV_GROUPS:
        raise ValueError(f"mont_inv: unknown lane group {group!r}; one of {INV_GROUPS}")
    check_limbs("mont_inv", a=a)
    if a.device.type == "cpu":
        return mont_inv_plain(spec, a)
    if a.device.type != "cuda":
        raise ValueError(f"mont_inv: unsupported device {a.device}")
    from .. import _build

    out = torch.empty_like(a)
    m = a.numel() // L
    if m == 0:
        return out
    group = group or inv_plan(m)
    _build.launch(
        "mont_inv", a.device, a.data_ptr(), out.data_ptr(), m, inv_words(spec).ctypes.data, ARITH[arith(spec)], group,
        _jump_table_device(a.device).data_ptr(),
    )
    LAUNCHES["mont_inv"] += 1
    return out


# ------------------------------------------------- chained-product latency
def mul_chain_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """x <- x * b, ``iters`` times from x = a, in :func:`mont_mul_plain`."""
    x = a
    for _ in range(iters):
        x = mont_mul_plain(spec, x, b)
    return x.clone() if x is a else x


def mul_chain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """A measurement of one chained product's latency: ``iters`` Montgomery
    products x <- x * b from x = a (one ``(16, 1)`` element each) in one
    thread of the ``mul_chain`` kernel, with the curve kernels' and the
    ladders' product (``csrc/field_cc.cuh``'s carry chains); its device time
    over ``iters`` is one product's chain.  CPU tensors:
    :func:`mul_chain_plain`.  On no prove path, so ``LAUNCHES`` does not
    count it."""
    check_limbs("mul_chain", a=a, b=b)
    if a.shape != (L, 1) or b.shape != (L, 1):
        raise ValueError(f"mul_chain: a and b must be (16, 1), got {tuple(a.shape)}, {tuple(b.shape)}")
    if iters < 0:
        raise ValueError(f"mul_chain: iters must be >= 0, got {iters}")
    if a.device.type == "cpu":
        return mul_chain_plain(spec, a, b, iters)
    if a.device.type != "cuda":
        raise ValueError(f"mul_chain: unsupported device {a.device}")
    from .. import _build

    out = torch.empty_like(a)
    _build.launch("mul_chain", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), iters, modulus_words(spec).ctypes.data)
    return out

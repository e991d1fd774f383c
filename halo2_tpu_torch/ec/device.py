"""BN254 G1 arithmetic on torch tensors: batched Jacobian ops and the
Pippenger MSM (port of halo2_tpu/ec/device.py).

Points are dicts ``{x, y, z}`` of ``(16, *B)`` int32 Montgomery limb tensors
over BN254 Fq; z == 0 marks infinity.  ``jac_add``/``jac_madd`` go to the
CUDA kernels of :mod:`.cuda_jac` for CUDA tensors (their plain versions for
CPU tensors), as do ``scalar_mul_batched`` (the ``jac_ladder`` kernel,
the whole double-and-add in one launch) and ``fixed_base_mul`` (the
``jac_fixed_base`` kernel: one shared point's multiples from its window
table); doubling, the inverse and the
selects are :class:`DeviceField` ops, whose squares, multiplies and
inverses (one ``mont_inv`` launch) are the CUDA kernels of
:mod:`..field.cuda_mul`.

The MSM keeps the reference's schedule: window digits from canonical
limbs, signed digits, a per-window sort by (digit, sign, index), q rounds of
mixed adds that build each chunk's running suffix sums, a cross-chunk
exclusive suffix scan, the Abel-summation window combine, a tree sum per
window, and a host Horner tail over Python ints.  The schedule's sizes
(``_msm_c``, ``_q_rounds``) are the reference's; the result does not depend
on them.  The chunk rounds are one ``msm_chunk_acc`` launch and the scan a
``jac_suffix_scan`` in one to three launches (``csrc/msm.cu``), where the
reference compiles ``fori_loop``s; the scan's association order is not the
reference's sequential one, so window sums are other Jacobian
representatives of the reference's points.  A batch of scalar sets over
the same points runs every step once over all its sets' windows.

The host tail (``_hj_dbl``, ``_hj_madd``, ``_hj_add``, ``_host_horner``) is
carried over verbatim: the reference's file imports JAX, so this package
cannot load it.  ``msm_hybrid`` runs a leading slice of the points on the
device Pippenger while the native host Pippenger takes the rest, in a
worker thread.  :func:`_msm_raw` keeps the whole MSM on the device (the
Horner combine too, one ``jac_horner`` launch a batch), for the sharded
prover, whose ranks exchange the result, and for device commitments.  The
reference's ``pvary_tree`` only marks loop carries as device-varying for
``shard_map``'s type check and has no counterpart here.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..field.device import DeviceField, get_device_field
from ..field.params import BN254_FQ, NUM_LIMBS as L
from .cuda_jac import (
    FIXED_BASE_WINDOW,
    fixed_base_table_tensor,
    jac_add_cuda,
    jac_fixed_base_cuda,
    jac_horner_cuda,
    jac_ladder_cuda,
    jac_madd_cuda,
    jac_suffix_scan_cuda,
    msm_chunk_acc_cuda,
)


def df() -> DeviceField:
    return get_device_field(BN254_FQ)


def jac(x, y, z):
    return {"x": x, "y": y, "z": z}


def jac_infinity(batch=(), device=None):
    d = df()
    return jac(
        d.zeros(batch, device=device),
        d.one_mont(batch, device=device).contiguous(),
        d.zeros(batch, device=device),
    )


def jac_from_affine(x, y):
    """x, y: (16, *B) Montgomery; (0,0) treated as infinity."""
    d = df()
    inf = d.is_zero(x) & d.is_zero(y)
    z = d.select(inf, d.zeros(x.shape[1:], device=x.device), d.one_mont(x.shape[1:], device=x.device))
    return jac(x, y, z)


def is_infinity(p):
    return df().is_zero(p["z"])


def jac_neg(p):
    return jac(p["x"], df().neg(p["y"]), p["z"])


def jac_double(p, d=None):
    """dbl-2009-l for a=0: 3M + 4S + ...  ``d``: the field whose ops run it
    (the plain group ops pass theirs)."""
    d = d or df()
    x, y, z = p["x"], p["y"], p["z"]
    a = d.square(x)
    b = d.square(y)
    c = d.square(b)
    t = d.square(d.add(x, b))
    dd = d.double(d.sub(d.sub(t, a), c))
    e = d.add(d.double(a), a)
    f = d.square(e)
    x3 = d.sub(f, d.double(dd))
    y3 = d.sub(d.mul(e, d.sub(dd, x3)), d.double(d.double(d.double(c))))
    z3 = d.double(d.mul(y, z))
    # doubling a point with y=0 or infinity gives infinity (z3 = 0) naturally
    return jac(x3, y3, z3)


def _contig(p):
    return {k: v.contiguous() for k, v in p.items()}


def jac_add(p, q):
    """Complete Jacobian addition (the ``jac_add`` kernel on CUDA tensors)."""
    return jac_add_cuda(_contig(p), _contig(q))


def jac_madd(p, qx, qy, valid):
    """Mixed add p + (qx, qy) where ``valid`` else p (the ``jac_madd`` kernel
    on CUDA tensors); (qx, qy) is a finite affine point on valid lanes."""
    return jac_madd_cuda(_contig(p), qx.contiguous(), qy.contiguous(), valid.contiguous())


def jac_to_affine(p):
    """Batch-normalize to affine (Montgomery); infinity -> (0, 0).  z^-2 is
    the product z^-1 z^-1 (the square's limbs), so the setup after its
    ladder launches ``mont_inv`` and ``mont_mul`` alone."""
    d = df()
    zinv = d.inv(p["z"])
    zinv2 = d.mul(zinv, zinv)
    x = d.mul(p["x"], zinv2)
    y = d.mul(p["y"], d.mul(zinv2, zinv))
    inf = d.is_zero(p["z"])
    zero = d.zeros(x.shape[1:], device=x.device)
    return d.select(inf, zero, x), d.select(inf, zero, y)


def scalar_mul_batched(points, scalar_bits):
    """points: jac dict (16, N); scalar_bits: (nbits, N) uint8 or int32
    rows, nonzero = set — per-point double-and-add, batched over N (LSB
    first): one ``jac_ladder`` launch on CUDA tensors, its plain version on
    CPU ones."""
    return jac_ladder_cuda(_contig(points), scalar_bits.contiguous())


def fixed_base_mul(point, scalars):
    """[s_i] P for one finite affine point P = ``point`` (x, y) ints over
    Fq, shared by every lane, and ``(8, N)`` int32 little-endian scalar
    words (any value below 2^256) on a device: one ``jac_fixed_base``
    launch on a CUDA tensor, its plain version on a CPU one, over P's window
    table (built once per point and device).  Returns a jac dict ``(16,
    N)``.  The setup's G tau^i; the reference runs it as
    ``scalar_mul_batched`` over G on every lane (``halo2_tpu/kzg/params.py:74``)."""
    x, y = (int(c) for c in point)
    table = fixed_base_table_tensor(x, y, FIXED_BASE_WINDOW, scalars.device)
    return jac_fixed_base_cuda(table, scalars.contiguous())


# ---------------------------------------------------------------------- MSM
#
# Per window w the sum is  sum_e d_e * P_e  (d_e = the signed c-bit digit's
# magnitude, P_e negated where its sign is set).  Sorting the window's
# entries by digit makes the digit sequence monotone, so by Abel summation
# sum_e d_e P_e = sum_{k=1}^{2^(c-1)} S(pos_k), where S(p) is the sum of the
# sorted points at positions >= p and pos_k = searchsorted(sorted_digits, k).
# Each lane owns a contiguous chunk of q sorted entries and emits its running
# intra-chunk suffixes (q rounds of mixed adds, every lane busy every round);
# a hierarchical scan of the chunk totals gives the cross-chunk suffixes.


def _msm_c(n: int) -> int:
    """Window bits: larger windows cut adds (W*n total) but cost B=2^c adds
    in the Abel combine — worth it once n*W >> 2^c."""
    if n < 256:
        return 4
    if n < (1 << 14):
        return 8
    return 12


def _digits_from_limbs(scalars_canonical, c: int):
    """(..., 16, N) canonical 16-bit limbs -> (..., W, N) int64 c-bit
    digits (c <= 16): digit k is bits k c .. k c + c - 1, read from the
    32 bits of limbs l0 and l0 + 1 (l0 = k c // 16; a 17th limb of 0)."""
    w_n = -(-254 // c)
    s = scalars_canonical.to(torch.int64)
    s = torch.cat([s, torch.zeros_like(s[..., :1, :])], dim=-2)
    bits = torch.arange(w_n, device=s.device) * c
    l0, off = bits // 16, bits % 16
    pair = s[..., l0, :] | (s[..., l0 + 1, :] << 16)
    return (pair >> off[:, None]) & ((1 << c) - 1)


def _signed_digits(digits, c: int):
    """Unsigned c-bit digits (..., W, N) -> (magnitudes, signs): d' = d +
    carry, and d' > 2^(c-1) is emitted as -(2^c - d') with carry 1, so
    magnitudes stay <= 2^(c-1) and the Abel combine runs over half the
    positions.  The top window absorbs the final carry (its raw digit is
    far below 2^(c-1) for every window size _msm_c chooses)."""
    w_n = digits.shape[-2]
    half, full = 1 << (c - 1), 1 << c
    mags, signs = [], []
    carry = torch.zeros_like(digits[..., 0, :])
    for k in range(w_n - 1):
        d = digits[..., k, :] + carry
        neg = d > half
        mags.append(torch.where(neg, full - d, d))
        signs.append(neg.to(digits.dtype))
        carry = neg.to(digits.dtype)
    mags.append(digits[..., w_n - 1, :] + carry)
    signs.append(torch.zeros_like(carry))
    return torch.stack(mags, dim=-2), torch.stack(signs, dim=-2)


def _tree_sum(terms):
    """Sum all entries of the last axis by radix-16 folds: a fold adds each
    group of 16 adjacent entries (fewer in the last fold) from its first
    on, the groups' entries moved to a leading axis once so that every add
    reads whole tensors."""
    while terms["x"].shape[-1] > 1:
        M = terms["x"].shape[-1]
        Q = min(16, M)
        v = {k: a.reshape(a.shape[:-1] + (M // Q, Q)).movedim(-1, 0).contiguous() for k, a in terms.items()}
        terms = {k: a[0] for k, a in v.items()}
        for r in range(1, Q):
            terms = jac_add(terms, {k: a[r] for k, a in v.items()})
    return {k: v[..., 0] for k, v in terms.items()}


def _sorted_entries(digits, signs, q: int):
    """One sort of each row's entries by one int64 key (magnitude | sign |
    index): the sorted magnitudes ``(R, n)``, and the entries' point
    indices (int32) and signs (bool) in chunks of q sorted entries,
    position-major: ``(R, q, n / q)``, sorted entry c q + pos of a row at
    ``[r, pos, c]`` (what ``msm_chunk_acc`` takes)."""
    rows, n = digits.shape
    ib = max(1, (n - 1).bit_length())
    idx = torch.arange(n, dtype=torch.int64, device=digits.device)
    key = (digits << (ib + 1)) | (signs << ib) | idx
    skey, _ = torch.sort(key, dim=1)
    order = (skey & ((1 << ib) - 1)).to(torch.int32).reshape(rows, n // q, q).transpose(1, 2).contiguous()
    sign = ((skey >> ib) & 1).to(torch.bool).reshape(rows, n // q, q).transpose(1, 2).contiguous()
    return skey >> (ib + 1), order, sign


def _window_sums(px, py, digits, signs, c: int, q_rounds: int = 8):
    """Window sums sum_e d_e P_e of every row at once: a row is one window
    of one scalar set (R = sets x windows), over the same points.

    px, py: (16, n) affine Montgomery ((0,0) rows must have digit 0 — their
    garbage contributions only ever pollute suffix positions below pos_1,
    which the Abel combine never reads).  digits, signs: (R, n) int64.
    Returns a jac dict (16, R).
    """
    rows, n = digits.shape
    device = px.device
    B_eff = 1 << (c - 1)  # signed digits: magnitudes <= 2^(c-1)
    C = max(1, n // q_rounds)  # chunks per row
    q = n // C  # accumulation rounds
    sd, order, sign = _sorted_entries(digits, signs, q)

    # ---- intra-chunk suffix accumulation: q rounds in one launch, every
    # lane busy; sfx (3, 16, R, q C) holds each entry's running chunk
    # suffix, sorted entry c q + pos at pos C + c
    sfx, totals = msm_chunk_acc_cuda(px.contiguous(), py.contiguous(), order, sign)

    # ---- cross-chunk exclusive suffixes CS[ch] = sum of chunks after ch
    cs = jac_suffix_scan_cuda(totals)  # (3, 16, R, C)

    # ---- Abel combine: sum_k S(pos_k), k = 1..B_eff (signed magnitudes)
    ks = torch.arange(1, B_eff + 1, dtype=sd.dtype, device=device).expand(rows, B_eff)
    pos = torch.searchsorted(sd, ks.contiguous())  # (R, B_eff)
    ok = pos < n
    posc = pos.clamp(0, n - 1)
    s_intra = torch.gather(sfx, 3, (posc % q * C + posc // q).expand(3, L, rows, B_eff))
    s_cross = torch.gather(cs, 3, (posc // q).expand(3, L, rows, B_eff))
    del sfx
    terms = jac_add(
        {"x": s_intra[0], "y": s_intra[1], "z": s_intra[2]}, {"x": s_cross[0], "y": s_cross[1], "z": s_cross[2]}
    )  # (16, R, B_eff)
    inf = jac_infinity((rows, B_eff), device=device)
    d = df()
    terms = {k: d.select(~ok, inf[k], v) for k, v in terms.items()}
    return _tree_sum(terms)  # (16, R)


def _q_rounds(n: int) -> int:
    """Accumulation rounds per chunk: the reference's choice (8 up to 2^16
    points, 16 above, where 8 would make the cross-chunk scan C = n/8 wide)."""
    return 8 if n <= (1 << 16) else 16


def _chunkable_n(n: int, q: int) -> int:
    """Smallest m >= n that the reference's _window_sums can chunk: m = q*C
    with C either <= 64 or recursively a multiple of 64 (its
    _excl_suffix_scan radix; jac_suffix_scan takes any C), kept so that
    both pad alike.  Padding entries are (0,0) points with
    digit 0 — sorted first and never read by the Abel combine (same invariant
    as real infinity inputs)."""
    if n < q:
        return n

    def round_chunks(C):
        if C <= 64:
            return C
        return 64 * round_chunks(-(-C // 64))

    return q * round_chunks(-(-n // q))


# bytes of the running suffix sums a scalar set's window sums hold at once
# (3 coordinates x 16 limbs x 4 bytes for each of W x n entries), and the
# most a batch of scalar sets holds before it is split into sub-batches:
# one set at the 2^18-point slice (22 windows: 1.1 GB, as _MSM_SLICE), 3,
# 85 and 682 sets at 2^16, 2^11 and 2^8 points
_SFX_BYTES = 3 * L * 4
_MSM_BATCH_BYTES = 1 << 30


def _batch_sets(n: int, c: int) -> int:
    """Scalar sets of one sub-batch at n (padded) points and c-bit windows."""
    return max(1, _MSM_BATCH_BYTES // (_SFX_BYTES * -(-254 // c) * n))


def _msm_wsums_raw(px, py, scalars_canonical):
    """Device Pippenger through window sums: (px, py, scalars) -> stacked
    Jacobian window sums, ONE (3, 16, W) tensor (x/y/z), normalized to affine
    on the host.  The Horner window combine (c*W sequential doublings at
    width 1) runs on the host over Python ints.  Scalars may also be a batch
    ``(B, 16, N)`` of scalar sets over the same points, giving ``(3, 16, B,
    W)``: every step runs once over all the sets' windows, in sub-batches
    of ``_batch_sets`` sets."""
    n = px.shape[-1]
    c = _msm_c(n)
    q = _q_rounds(n)
    m = _chunkable_n(n, q)
    if m != n:
        pad = (0, m - n)
        px = torch.nn.functional.pad(px, pad)
        py = torch.nn.functional.pad(py, pad)
        scalars_canonical = torch.nn.functional.pad(scalars_canonical, pad)
    single = scalars_canonical.dim() == 2
    sets = scalars_canonical[None] if single else scalars_canonical
    w_n = -(-254 // c)
    # infinity inputs ((0,0) marker) can't ride the mixed add — force
    # digit 0, which the Abel combine never reads
    pt_inf = df().is_zero(px) & df().is_zero(py)
    per = _batch_sets(m, c)
    parts = []
    for s in range(0, sets.shape[0], per):
        digits = torch.where(pt_inf, 0, _digits_from_limbs(sets[s : s + per], c))  # (b, W, m)
        digits, signs = _signed_digits(digits, c)
        b = digits.shape[0]
        w = _window_sums(px, py, digits.reshape(b * w_n, m), signs.reshape(b * w_n, m), c, q_rounds=q)
        parts.append(torch.stack([w["x"], w["y"], w["z"]]).reshape(3, L, b, w_n))
    w = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
    return w[:, :, 0] if single else w


def _horner_device(w, c: int):
    """Stacked ``(3, 16, *B, W)`` window sums -> sum_i 2^(c i) w_i as a jac
    point ``(16, *B)`` on their device: from the top window down, c
    doublings and one complete add (the reference's ``fori_loop`` Horner, at
    width 1 for one MSM, B for a batch), in one ``jac_horner`` launch."""
    return jac_horner_cuda(w.contiguous(), c)


def _msm_raw(px, py, scalars_canonical):
    """The fully-device MSM: :func:`_msm_wsums_raw`'s window sums and the
    Horner combine on the device; returns a jac point ``(16,)`` on px's
    device, which a collective can exchange (the sharded MSM's partial
    sums).  Inputs as for :func:`msm`; scalars may also be a batch
    ``(B, 16, N)`` of scalar sets over the same points, giving ``(16, B)``:
    one window-sum pass (:func:`_msm_wsums_raw`) and one Horner at width B
    for all of them.  Above ``_MSM_SLICE`` points the slices' sums add on
    the device."""
    n = px.shape[-1]
    if n > _MSM_SLICE:
        acc = None
        for s in range(0, n, _MSM_SLICE):
            e = min(n, s + _MSM_SLICE)
            pt = _msm_raw(px[:, s:e], py[:, s:e], scalars_canonical[..., s:e])
            acc = pt if acc is None else jac_add(acc, pt)
        return acc
    return _horner_device(_msm_wsums_raw(px, py, scalars_canonical), _msm_c(n))


# ---------------------------------------------- host Jacobian (Python ints)
def _hj_dbl(p, q):
    """dbl-2009-l on host ints; p = (X, Y, Z) or None for infinity."""
    if p is None:
        return None
    X, Y, Z = p
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    D = 2 * ((X + B) * (X + B) - A - C) % q
    E = 3 * A % q
    F = E * E % q
    X3 = (F - 2 * D) % q
    Y3 = (E * (D - X3) - 8 * C) % q
    Z3 = 2 * Y * Z % q
    return None if Z3 == 0 else (X3, Y3, Z3)


def _hj_madd(p, x2, y2, q):
    """Mixed add p + affine(x2, y2) on host ints."""
    if p is None:
        return (x2, y2, 1)
    X, Y, Z = p
    Z2 = Z * Z % q
    U2 = x2 * Z2 % q
    S2 = y2 * Z * Z2 % q
    if U2 == X:
        if S2 == Y:
            return _hj_dbl(p, q)
        return None
    H = (U2 - X) % q
    HH = H * H % q
    I = 4 * HH % q
    J = H * I % q
    rr = 2 * (S2 - Y) % q
    V = X * I % q
    X3 = (rr * rr - J - 2 * V) % q
    Y3 = (rr * (V - X3) - 2 * Y * J) % q
    Z3 = ((Z + H) * (Z + H) - Z2 - HH) % q
    return None if Z3 == 0 else (X3, Y3, Z3)


def _host_horner(wx_ints, wy_ints, c: int):
    """Window sums (host ints, (0,0)=infinity) -> final jac (X,Y,Z) or None."""
    q = BN254_FQ.p
    acc = None
    for x, y in zip(reversed(wx_ints), reversed(wy_ints)):
        for _ in range(c):
            acc = _hj_dbl(acc, q)
        if x or y:
            acc = _hj_madd(acc, int(x), int(y), q)
    return acc


def _hj_add(p, q2, q):
    """Full Jacobian + Jacobian add on host ints (None = infinity)."""
    if p is None:
        return q2
    if q2 is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q2
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    U2 = X2 * Z1Z1 % q
    S1 = Y1 * Z2 * Z2Z2 % q
    S2 = Y2 * Z1 * Z1Z1 % q
    if U1 == U2:
        if S1 == S2:
            return _hj_dbl(p, q)
        return None
    H = (U2 - U1) % q
    I = 4 * H * H % q
    J = H * I % q
    rr = 2 * (S2 - S1) % q
    V = U1 * I % q
    X3 = (rr * rr - J - 2 * V) % q
    Y3 = (rr * (V - X3) - 2 * S1 * J) % q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % q
    return None if Z3 == 0 else (X3, Y3, Z3)


def _encode_host_jac(pt, device=None):
    d = df()
    if pt is None:
        return jac_infinity((), device=device)
    X, Y, Z = pt
    enc = d.encode([X, Y, Z], device=device)
    return jac(enc[:, 0], enc[:, 1], enc[:, 2])


# largest single MSM pass: the suffix tensors are 3 * 16 * W * n int32, so
# n = 2^18 at c=12 is ~1.1 GB of device memory; larger inputs run in slices
# whose results combine with host Jacobian adds (linearity of the MSM).
_MSM_SLICE = 1 << 18


def _wsums_host_affine(w):
    """Stacked (3, 16, W) window sums -> host affine ints ((0,0)=inf), in one
    device -> host copy."""
    d = df()
    w_host = w.cpu()
    X, Y, Z = d.decode(w_host[0]), d.decode(w_host[1]), d.decode(w_host[2])
    q = BN254_FQ.p
    wx, wy = [], []
    for i in range(len(X)):
        if int(Z[i]) % q == 0:
            wx.append(0)
            wy.append(0)
        else:
            zi = pow(int(Z[i]), q - 2, q)
            zi2 = zi * zi % q
            wx.append(int(X[i]) * zi2 % q)
            wy.append(int(Y[i]) * zi2 % q * zi % q)
    return wx, wy


def _msm_host_point(px, py, scalars_canonical):
    """MSM -> host Jacobian tuple (X, Y, Z) or None (infinity)."""
    n = px.shape[-1]
    if n <= _MSM_SLICE:
        wx, wy = _wsums_host_affine(_msm_wsums_raw(px, py, scalars_canonical))
        return _host_horner(wx, wy, _msm_c(n))
    acc = None
    for s in range(0, n, _MSM_SLICE):
        e = min(n, s + _MSM_SLICE)
        pt = _msm_host_point(px[:, s:e], py[:, s:e], scalars_canonical[:, s:e])
        acc = _hj_add(acc, pt, BN254_FQ.p)
    return acc


def msm(px, py, scalars_canonical):
    """Multi-scalar multiplication.

    px, py: (16, N) int32 affine coordinates in Montgomery form ((0,0) =
    infinity); scalars_canonical: (16, N) int32 canonical (non-Montgomery)
    Fr limbs; all on one device.  Returns a jac point (16,) dict on that
    device (host Horner tail inside).
    """
    return _encode_host_jac(_msm_host_point(px, py, scalars_canonical), px.device)


def _hybrid_device_frac(n: int) -> float:
    """The share of an n-point hybrid MSM that runs on the device: all of it.
    On one H100 (700 W) the device alone was fastest at 2^16 and level with
    the best split (0.75) at 2^20, on the native engine's 8 threads or 7
    (``python -m halo2_tpu_torch.crossover``, PERF.md): the device MSM's
    time is its host dispatch, which a smaller slice hardly shortens and the
    host tail's threads slow down."""
    return 1.0


# 52-bit lane forms of host point mirrors, keyed by (id, id, slice start):
# the SRS arrays are long-lived and reused across every MSM of a prove or a
# bench, so the O(n) conversion is paid once.  An entry keeps the source
# arrays (ids cannot be recycled under it, and the identity check holds), and
# caching freezes them and the lane forms: an in-place write to a cached
# mirror raises instead of leaving a stale lane form here.  Least recently
# used entries go first; one 2^20-point entry is ~80 MB.
_PTS52_CACHE: collections.OrderedDict = collections.OrderedDict()
_PTS52_CACHE_MAX = 4
_PTS52_LOCK = threading.Lock()


def _host_pts52(host_px, host_py, nd):
    """The IFMA lane form of host_px/host_py[:, nd:], or None without IFMA."""
    key = (id(host_px), id(host_py), int(nd))
    with _PTS52_LOCK:
        ent = _PTS52_CACHE.get(key)
        if ent is not None and ent[0] is host_px and ent[1] is host_py:
            _PTS52_CACHE.move_to_end(key)
            return ent[2], ent[3]
    px = native.pack_device(np.asarray(host_px[:, nd:]))
    py = native.pack_device(np.asarray(host_py[:, nd:]))
    r = native.points_to52(px, py)
    if r is None:
        return None
    for a in (host_px, host_py, *r):
        a.flags.writeable = False
    with _PTS52_LOCK:
        _PTS52_CACHE[key] = (host_px, host_py, r[0], r[1])
        while len(_PTS52_CACHE) > _PTS52_CACHE_MAX:
            _PTS52_CACHE.popitem(last=False)
    return r


def _host_msm(host_px, host_py, host_scalars, nd):
    """The native host MSM of the points from nd on: a host Jacobian tuple,
    or None for infinity.  The IFMA Pippenger over cached lane forms where
    the host has IFMA, the 64-bit one otherwise."""
    sc = native.pack_device(np.asarray(host_scalars[:, nd:]))
    pts52 = _host_pts52(host_px, host_py, nd)
    if pts52 is not None:
        x, y = native.msm_g1_mont52(pts52[0], pts52[1], sc)
    else:
        x, y = native.msm_g1_mont(
            native.pack_device(np.asarray(host_px[:, nd:])),
            native.pack_device(np.asarray(host_py[:, nd:])),
            sc,
        )
    return (x, y, 1) if (x or y) else None


def msm_hybrid(px, py, scalars_canonical, host_px=None, host_py=None, host_scalars=None, device_frac=None):
    """Heterogeneous MSM: the device Pippenger runs the leading
    ``device_frac`` of the points while the native host Pippenger runs the
    tail in a worker thread (the native engine's ctypes calls release the
    interpreter lock, so the main thread dispatches the device work
    meanwhile); the two partial sums add on the host (MSM linearity).

    px, py, scalars_canonical: (16, N) int32 tensors on one device, as for
    :func:`msm`; host_*: (16, N) uint32 numpy mirrors of the same data
    (points Montgomery, scalars canonical).  The point mirrors are cached in
    their IFMA lane form and become read-only.  ``device_frac``: the device's
    share, clamped to [0, 1]; None takes :func:`_hybrid_device_frac`.
    Without mirrors or the native engine, below 2^12 points, or at a share
    of 1, this is :func:`msm`; at a share of 0 it is the host MSM alone.
    Returns a jac point on px's device."""
    n = px.shape[-1]
    if host_px is None or host_scalars is None or not native.available() or n < (1 << 12):
        return msm(px, py, scalars_canonical)
    frac = _hybrid_device_frac(n) if device_frac is None else min(1.0, max(0.0, float(device_frac)))
    nd = max(0, min(n, int(n * frac)))
    if nd == n:
        return msm(px, py, scalars_canonical)
    if nd == 0:
        return _encode_host_jac(_host_msm(host_px, host_py, host_scalars, 0), px.device)
    with ThreadPoolExecutor(max_workers=1) as pool:
        tail = pool.submit(_host_msm, host_px, host_py, host_scalars, nd)
        head = _msm_host_point(px[:, :nd], py[:, :nd], scalars_canonical[:, :nd])
        acc = _hj_add(tail.result(), head, BN254_FQ.p)
    return _encode_host_jac(acc, px.device)


def jac_host_affine(pt) -> tuple:
    """A single jac point (16,) on any device -> host affine ints (x, y),
    (0, 0) = infinity, in one copy per coordinate."""
    q = BN254_FQ.p
    X, Y, Z = (int(df().decode(pt[c][:, None].cpu())[0]) for c in ("x", "y", "z"))
    if Z % q == 0:
        return 0, 0
    zi = pow(Z, q - 2, q)
    return X * zi * zi % q, Y * zi * zi * zi % q


def msm_points(px, py, scalars_canonical):
    """MSM returning the result as host ints (x, y), (0, 0) = infinity."""
    pt = _msm_host_point(px, py, scalars_canonical)
    if pt is None:
        return 0, 0
    q = BN254_FQ.p
    X, Y, Z = pt
    zinv = pow(Z, q - 2, q)
    zinv2 = zinv * zinv % q
    return X * zinv2 % q, Y * zinv2 % q * zinv % q

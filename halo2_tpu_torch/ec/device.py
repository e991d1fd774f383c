"""BN254 G1 arithmetic on torch tensors: batched Jacobian ops and the
Pippenger MSM (port of halo2_tpu/ec/device.py).

Points are dicts ``{x, y, z}`` of ``(16, *B)`` int32 Montgomery limb tensors
over BN254 Fq; z == 0 marks infinity.  ``jac_add``/``jac_madd`` go to the
CUDA kernels of :mod:`.cuda_jac` for CUDA tensors (their plain versions for
CPU tensors); doubling, the inverse and the selects are :class:`DeviceField`
ops, whose squares, multiplies and inverses (one ``mont_inv`` launch) are
the CUDA kernels of :mod:`..field.cuda_mul`.

The MSM keeps the reference's schedule: window digits from canonical
limbs, signed digits, a per-window sort by (digit, sign, index), q rounds of
mixed adds that build each chunk's running suffix sums, a cross-chunk
exclusive suffix scan, the Abel-summation window combine, a tree sum per
window, and a host Horner tail over Python ints.  The schedule's sizes
(``_msm_c``, ``_q_rounds``) are the reference's; the result does not depend
on them.  JAX loops become Python loops, and ``dynamic_update_slice`` an
in-place slice write into a preallocated tensor.

The host tail (``_hj_dbl``, ``_hj_madd``, ``_hj_add``, ``_host_horner``) is
carried over verbatim: the reference's file imports JAX, so this package
cannot load it.  ``msm_hybrid`` runs a leading slice of the points on the
device Pippenger while the native host Pippenger takes the rest, in a
worker thread.  :func:`_msm_raw` keeps the whole MSM on the device (the
Horner combine too, one ``jac_horner`` launch), for the sharded prover,
whose ranks exchange the result.  The reference's ``pvary_tree`` only
marks loop carries as device-varying for ``shard_map``'s type check and
has no counterpart here.
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
from .cuda_jac import jac_add_cuda, jac_horner_cuda, jac_madd_cuda


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
    """Batch-normalize to affine (Montgomery); infinity -> (0, 0)."""
    d = df()
    zinv = d.inv(p["z"])
    zinv2 = d.square(zinv)
    x = d.mul(p["x"], zinv2)
    y = d.mul(p["y"], d.mul(zinv2, zinv))
    inf = d.is_zero(p["z"])
    zero = d.zeros(x.shape[1:], device=x.device)
    return d.select(inf, zero, x), d.select(inf, zero, y)


def scalar_mul_batched(points, scalar_bits):
    """points: jac dict (16, N); scalar_bits: (nbits, N) 0/1 tensor —
    per-point double-and-add, batched over N (LSB first)."""
    d = df()
    n = points["x"].shape[-1]
    acc, base = jac_infinity((n,), device=points["x"].device), points
    for r in range(scalar_bits.shape[0]):
        added = jac_add(acc, base)
        bit = scalar_bits[r] != 0
        acc = {k: d.select(bit, added[k], acc[k]) for k in acc}
        if r + 1 < scalar_bits.shape[0]:
            base = jac_double(base)
    return acc


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
    """(16, N) canonical 16-bit limbs -> (W, N) int64 c-bit digits (c<=16)."""
    w_n = -(-254 // c)
    s = scalars_canonical.to(torch.int64)
    outs = []
    for k in range(w_n):
        l0, off = divmod(k * c, 16)
        dig = s[l0] >> off
        if off + c > 16 and l0 + 1 < 16:
            dig = dig | (s[l0 + 1] << (16 - off))
        outs.append(dig & ((1 << c) - 1))
    return torch.stack(outs)


def _signed_digits(digits, c: int):
    """Unsigned c-bit digits -> (magnitudes, signs): d' = d + carry, and
    d' > 2^(c-1) is emitted as -(2^c - d') with carry 1, so magnitudes stay
    <= 2^(c-1) and the Abel combine runs over half the positions.  The top
    window absorbs the final carry (its raw digit is far below 2^(c-1) for
    every window size _msm_c chooses)."""
    w_n = digits.shape[0]
    half, full = 1 << (c - 1), 1 << c
    mags, signs = [], []
    carry = torch.zeros_like(digits[0])
    for k in range(w_n - 1):
        d = digits[k] + carry
        neg = d > half
        mags.append(torch.where(neg, full - d, d))
        signs.append(neg.to(digits.dtype))
        carry = neg.to(digits.dtype)
    mags.append(digits[w_n - 1] + carry)
    signs.append(torch.zeros_like(carry))
    return torch.stack(mags), torch.stack(signs)


def _fold_groups(terms, Q: int):
    """Sum groups of Q adjacent entries on the last axis: (..., M) -> (..., M//Q)."""
    M = terms["x"].shape[-1]
    G = M // Q
    v = {k: a.reshape(a.shape[:-1] + (G, Q)) for k, a in terms.items()}
    acc = {k: a[..., 0] for k, a in v.items()}
    for r in range(1, Q):
        acc = jac_add(acc, {k: a[..., r] for k, a in v.items()})
    return acc


def _tree_sum(terms):
    """Sum all entries of the last axis via radix-16 folds."""
    while terms["x"].shape[-1] > 1:
        M = terms["x"].shape[-1]
        terms = _fold_groups(terms, min(16, M))
    return {k: v[..., 0] for k, v in terms.items()}


def _excl_suffix_scan(pts, Q: int = 64):
    """Exclusive suffix sums over the last axis (power-of-2 length C):
    out[..., i] = sum_{j > i} pts[..., j].  Hierarchical: a running suffix
    within groups of Q, a recursive scan of the group totals, combined with
    one full-width add."""
    C = pts["x"].shape[-1]
    batch = pts["x"].shape[1:]
    device = pts["x"].device
    if C == 1:
        return jac_infinity(batch, device=device)
    if C <= Q:
        sfx = {k: torch.zeros((L,) + batch, dtype=torch.int32, device=device) for k in pts}
        acc = jac_infinity(batch[:-1], device=device)
        for r in range(C):
            pos = C - 1 - r
            for k in sfx:
                sfx[k][..., pos] = acc[k]
            acc = jac_add(acc, {k: a[..., pos] for k, a in pts.items()})
        return sfx
    G = C // Q
    v = {k: a.reshape(a.shape[:-1] + (G, Q)) for k, a in pts.items()}
    sfx = {k: torch.zeros_like(a) for k, a in v.items()}
    acc = jac_infinity(batch[:-1] + (G,), device=device)
    for r in range(Q):
        pos = Q - 1 - r
        for k in sfx:
            sfx[k][..., pos] = acc[k]
        acc = jac_add(acc, {k: a[..., pos] for k, a in v.items()})
    gsfx = _excl_suffix_scan(acc, Q)  # (16, ..., G)
    gb = {k: a[..., None].expand(a.shape + (Q,)) for k, a in gsfx.items()}
    out = jac_add(sfx, gb)
    return {k: a.reshape(a.shape[:-2] + (C,)) for k, a in out.items()}


def _window_sums(px, py, digits, signs, c: int, q_rounds: int = 8):
    """Window sums sum_e d_e P_e for all windows at once.

    px, py: (16, n) affine Montgomery ((0,0) rows must have digit 0 — their
    garbage contributions only ever pollute suffix positions below pos_1,
    which the Abel combine never reads).  digits, signs: (W, n) int64.
    Returns a jac dict (16, W).
    """
    w_n, n = digits.shape
    device = px.device
    B_eff = 1 << (c - 1)  # signed digits: magnitudes <= 2^(c-1)
    C = max(1, n // q_rounds)  # chunks per window
    q = n // C  # accumulation rounds

    # one int64 key per entry, (magnitude | sign | index): one sort per
    # window row gives the digit order, the signs and the point indices
    ib = max(1, (n - 1).bit_length())
    idx = torch.arange(n, dtype=torch.int64, device=device)
    key = (digits << (ib + 1)) | (signs << ib) | idx[None, :]
    skey, _ = torch.sort(key, dim=1)
    order = skey & ((1 << ib) - 1)  # (W, n)
    sign_sorted = ((skey >> ib) & 1).to(torch.bool)
    sd = skey >> (ib + 1)
    order_cq = order.reshape(w_n, C, q)
    sign_cq = sign_sorted.reshape(w_n, C, q)
    stacked = torch.cat([px, py])  # (32, n): one gather per round

    # ---- intra-chunk suffix accumulation: q rounds, every lane busy
    valid = torch.ones((w_n, C), dtype=torch.bool, device=device)
    sfx = {k: torch.zeros((L, w_n, C, q), dtype=torch.int32, device=device) for k in ("x", "y", "z")}
    acc = jac_infinity((w_n, C), device=device)
    d = df()
    for r in range(q):
        pos = q - 1 - r
        g = stacked[:, order_cq[:, :, pos]]  # (32, W, C)
        qy = g[16:]
        qy = d.select(sign_cq[:, :, pos], d.neg(qy), qy)  # signed-digit negation
        acc = jac_madd(acc, g[:16], qy, valid)
        for k in sfx:
            sfx[k][..., pos] = acc[k]
    sfx = {k: v.reshape(L, w_n, n) for k, v in sfx.items()}

    # ---- cross-chunk exclusive suffixes CS[ch] = sum of chunks after ch
    CS = _excl_suffix_scan(acc)  # (16, W, C)

    # ---- Abel combine: sum_k S(pos_k), k = 1..B_eff (signed magnitudes)
    ks = torch.arange(1, B_eff + 1, dtype=sd.dtype, device=device).expand(w_n, B_eff)
    pos = torch.searchsorted(sd, ks.contiguous())  # (W, B_eff)
    ok = pos < n
    posc = pos.clamp(0, n - 1)
    s_intra = {k: torch.gather(v, 2, posc[None].expand(L, w_n, B_eff)) for k, v in sfx.items()}
    s_cross = {k: torch.gather(v, 2, (posc // q)[None].expand(L, w_n, B_eff)) for k, v in CS.items()}
    del sfx
    terms = jac_add(s_intra, s_cross)  # (16, W, B_eff)
    inf = jac_infinity((w_n, B_eff), device=device)
    terms = {k: d.select(~ok, inf[k], v) for k, v in terms.items()}
    return _tree_sum(terms)  # (16, W)


def _q_rounds(n: int) -> int:
    """Accumulation rounds per chunk: the reference's choice (8 up to 2^16
    points, 16 above, where 8 would make the cross-chunk scan C = n/8 wide)."""
    return 8 if n <= (1 << 16) else 16


def _chunkable_n(n: int, q: int) -> int:
    """Smallest m >= n that _window_sums can chunk: m = q*C with C either
    <= 64 or recursively a multiple of 64 (the _excl_suffix_scan radix), so
    C*q == m holds at every level.  Padding entries are (0,0) points with
    digit 0 — sorted first and never read by the Abel combine (same invariant
    as real infinity inputs)."""
    if n < q:
        return n

    def round_chunks(C):
        if C <= 64:
            return C
        return 64 * round_chunks(-(-C // 64))

    return q * round_chunks(-(-n // q))


def _msm_wsums_raw(px, py, scalars_canonical):
    """Device Pippenger through window sums: (px, py, scalars) -> stacked
    Jacobian window sums, ONE (3, 16, W) tensor (x/y/z), normalized to affine
    on the host.  The Horner window combine (c*W sequential doublings at
    width 1) runs on the host over Python ints."""
    n = px.shape[-1]
    c = _msm_c(n)
    q = _q_rounds(n)
    m = _chunkable_n(n, q)
    if m != n:
        pad = (0, m - n)
        px = torch.nn.functional.pad(px, pad)
        py = torch.nn.functional.pad(py, pad)
        scalars_canonical = torch.nn.functional.pad(scalars_canonical, pad)
    digits = _digits_from_limbs(scalars_canonical, c)
    # infinity inputs ((0,0) marker) can't ride the mixed add — force
    # digit 0, which the Abel combine never reads
    pt_inf = df().is_zero(px) & df().is_zero(py)
    digits = torch.where(pt_inf[None], 0, digits)
    digits, signs = _signed_digits(digits, c)
    w = _window_sums(px, py, digits, signs, c, q_rounds=q)
    return torch.stack([w["x"], w["y"], w["z"]])


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
    one Horner at width B for all of them.  Above ``_MSM_SLICE`` points the
    slices' sums add on the device."""
    n = px.shape[-1]
    if n > _MSM_SLICE:
        acc = None
        for s in range(0, n, _MSM_SLICE):
            e = min(n, s + _MSM_SLICE)
            pt = _msm_raw(px[:, s:e], py[:, s:e], scalars_canonical[..., s:e])
            acc = pt if acc is None else jac_add(acc, pt)
        return acc
    if scalars_canonical.dim() == 2:
        w = _msm_wsums_raw(px, py, scalars_canonical)
    else:
        w = torch.stack([_msm_wsums_raw(px, py, sc) for sc in scalars_canonical.unbind(0)], dim=2)
    return _horner_device(w, _msm_c(n))


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

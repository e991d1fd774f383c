"""SHPLONK multiopen (halo2 `ProverSHPLONK` / `VerifierSHPLONK`, BDFG20).

Opens many (poly, point-set) pairs with TWO G1 elements:
  f(X) = sum_i v^i * Z_{T\\S_i}(X) * (f_i(X) - r_i(X)),   H = f / Z_T
  L(X) = sum_i v^i * Z_{T\\S_i}(u) * (f_i(X) - r_i(u)) - Z_T(u) H(X)
  W    = L / (X - u)
Verification folds commitments the same way and checks
  e(C_L + u*C_W, [1]_2) == e(C_W, [tau]_2)  (SingleStrategy: immediate check).
Reference call-surface: src/circuits/utils.rs:40-63.
"""

from __future__ import annotations

import numpy as np

from ..ec import host as ec
from ..field.device import get_device_field
from ..field.params import BN254_FR
from .expr_eval import poly_eval

P = BN254_FR.p


# ----------------------------------------------------- host poly arithmetic
def poly_from_roots(roots):
    out = [1]
    for r in roots:
        nxt = [0] * (len(out) + 1)
        for i, c in enumerate(out):
            nxt[i + 1] = (nxt[i + 1] + c) % P
            nxt[i] = (nxt[i] - c * r) % P
        out = nxt
    return out


def poly_add_scaled(acc, poly, scale):
    """acc += poly * scale — vectorized (numpy object arrays of ints)."""
    acc = np.asarray(acc, dtype=object)
    poly = np.asarray(poly, dtype=object)
    if len(acc) < len(poly):
        acc = np.concatenate([acc, np.zeros(len(poly) - len(acc), dtype=object)])
    acc[: len(poly)] = (acc[: len(poly)] + poly * scale) % P
    return acc


def poly_mul(a, b):
    """Product via shifted adds of the SHORTER operand (the multiopen only
    multiplies degree-n polys by tiny vanishing factors)."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    if len(b) > len(a):
        a, b = b, a
    out = np.zeros(len(a) + len(b) - 1, dtype=object)
    for j, y in enumerate(b):
        if y:
            out[j : j + len(a)] = (out[j : j + len(a)] + a * y) % P
    return out


def poly_div_exact(f, divisor):
    """f / divisor, asserting zero remainder; divisor monic-ized internally."""
    f = [int(v) for v in f]
    divisor = [int(v) for v in divisor]
    d = len(divisor) - 1
    lead_inv = pow(divisor[-1], -1, P)
    out = [0] * max(len(f) - d, 1)
    for i in range(len(f) - 1, d - 1, -1):
        q = f[i] * lead_inv % P
        out[i - d] = q
        if q:
            for j, c in enumerate(divisor):
                f[i - d + j] = (f[i - d + j] - q * c) % P
    assert all(c % P == 0 for c in f[:d]), "non-zero remainder in multiopen division"
    return out


def lagrange_interp(points, values):
    """Coefficients of the unique poly with poly(points[i]) = values[i]."""
    out = [0] * len(points)
    for i, (xi, yi) in enumerate(zip(points, values)):
        num = [1]
        den = 1
        for j, xj in enumerate(points):
            if i == j:
                continue
            num = poly_mul(num, [(-xj) % P, 1])
            den = den * ((xi - xj) % P) % P
        scale = yi * pow(den, -1, P) % P
        out = poly_add_scaled(out, num, scale)
    return out


# ------------------------------------------------------------------- prover
def shplonk_open(params, transcript, polys, queries, evals, commit=None):
    """``commit`` maps a host coefficient poly (int list or (n, 4) u64 array)
    to a G1 point; defaults to the device commit path (the prover injects its
    engine's committer).  Dispatches to the native-kernel body when the C++
    engine is available (object-array poly arithmetic cost ~0.5 s per prove)."""
    if commit is None:
        def commit(coeffs):
            from .. import native as _n
            from .keygen import commit_coeffs

            if isinstance(coeffs, np.ndarray) and coeffs.dtype == np.uint64:
                coeffs = _n.unpack_ints(coeffs)
            dfr = get_device_field(BN254_FR)
            return commit_coeffs(params, dfr.encode([int(c) for c in coeffs]))

    from .. import native

    if native.available():
        return _shplonk_open_native(
            params, transcript, polys, queries, evals, commit, native
        )
    polys = {
        k: (native.unpack_ints(p) if isinstance(p, np.ndarray) and p.dtype == np.uint64 else p)
        for k, p in polys.items()
    }

    v = int(transcript.squeeze_challenge())
    points_of = {}
    for label, pt in queries:
        points_of.setdefault(label, []).append(pt)
    labels = sorted(points_of)
    T = sorted({pt for _, pt in queries})

    r_coeffs = {}
    f = [0]
    vi = 1
    for label in labels:
        S = sorted(set(points_of[label]))
        r = lagrange_interp(S, [evals[(label, s)] for s in S])
        r_coeffs[label] = r
        diff = np.array(polys[label], dtype=object)
        rr = np.asarray(r, dtype=object)
        diff[: len(rr)] = (diff[: len(rr)] - rr) % P
        zfac = poly_from_roots([t for t in T if t not in S])
        f = poly_add_scaled(f, poly_mul(diff, zfac), vi)
        vi = vi * v % P

    h = poly_div_exact(f, [int(v) for v in poly_from_roots(T)])
    n = params.n
    h = (h + [0] * n)[:n]
    transcript.write_point(commit(h))

    u_pt = int(transcript.squeeze_challenge())

    L = [0]
    vi = 1
    for label in labels:
        S = sorted(set(points_of[label]))
        z_u = 1
        for t in T:
            if t not in S:
                z_u = z_u * ((u_pt - t) % P) % P
        diff = np.array(polys[label], dtype=object)
        diff[0] = (diff[0] - poly_eval(r_coeffs[label], u_pt)) % P
        L = poly_add_scaled(L, diff, vi * z_u % P)
        vi = vi * v % P
    zt_u = 1
    for t in T:
        zt_u = zt_u * ((u_pt - t) % P) % P
    L = poly_add_scaled(L, h, (-zt_u) % P)
    w = poly_div_exact(L, [(-u_pt) % P, 1])
    w = (w + [0] * n)[:n]
    transcript.write_point(commit(w))


def _shplonk_open_native(params, transcript, polys, queries, evals, commit, nat):
    """shplonk_open body over (n, 4) u64 host polys with native kernels —
    byte-identical transcript to the object-array path (same algorithm,
    same ordering)."""

    def as_arr(p):
        if isinstance(p, np.ndarray) and p.dtype == np.uint64:
            return p
        return nat.pack_ints([int(c) % P for c in p])

    def patch(arr, idx, delta):
        """arr[idx] = (arr[idx] + delta) mod P on a packed element."""
        val = nat.unpack_ints(arr[idx : idx + 1])[0]
        arr[idx] = nat.pack_ints([(val + delta) % P])[0]

    polys = {k: as_arr(p_) for k, p_ in polys.items()}

    v = int(transcript.squeeze_challenge())
    points_of = {}
    for label, pt in queries:
        points_of.setdefault(label, []).append(pt)
    labels = sorted(points_of)
    T = sorted({pt for _, pt in queries})

    n = params.n
    max_len = max(p_.shape[0] for p_ in polys.values())
    r_coeffs = {}
    f = np.zeros((max_len + len(T), 4), np.uint64)
    vi = 1
    for label in labels:
        S = sorted(set(points_of[label]))
        r = [int(c) for c in lagrange_interp(S, [evals[(label, s)] for s in S])]
        r_coeffs[label] = r
        diff = polys[label].copy()
        for j, c in enumerate(r):
            patch(diff, j, -int(c))
        zfac = poly_from_roots([t for t in T if t not in S])
        for j, zc in enumerate(int(c) for c in zfac):
            if zc:
                nat.axpy_fr_inplace(f[j : j + diff.shape[0]], diff, vi * zc % P)
        vi = vi * v % P

    h = nat.poly_div_fr(f, [int(c) for c in poly_from_roots(T)])
    h_n = np.zeros((n, 4), np.uint64)
    h_n[: min(n, h.shape[0])] = h[:n]
    transcript.write_point(commit(h_n))

    u_pt = int(transcript.squeeze_challenge())

    L = np.zeros((max_len, 4), np.uint64)
    vi = 1
    for label in labels:
        S = sorted(set(points_of[label]))
        z_u = 1
        for t in T:
            if t not in S:
                z_u = z_u * ((u_pt - t) % P) % P
        diff = polys[label].copy()
        patch(diff, 0, -poly_eval(r_coeffs[label], u_pt))
        nat.axpy_fr_inplace(L[: diff.shape[0]], diff, vi * z_u % P)
        vi = vi * v % P
    zt_u = 1
    for t in T:
        zt_u = zt_u * ((u_pt - t) % P) % P
    nat.axpy_fr_inplace(L[: h_n.shape[0]], h_n, (-zt_u) % P)
    w = nat.poly_div_fr(L, [(-u_pt) % P, 1])
    w_n = np.zeros((n, 4), np.uint64)
    w_n[: min(n, w.shape[0])] = w[:n]
    transcript.write_point(commit(w_n))


# ----------------------------------------------------------------- verifier
def shplonk_verify(params, transcript, commitments, queries, evals) -> bool:
    v = int(transcript.squeeze_challenge())
    c_h = transcript.read_point()
    u_pt = int(transcript.squeeze_challenge())
    c_w = transcript.read_point()

    points_of = {}
    for label, pt in queries:
        points_of.setdefault(label, []).append(pt)
    labels = sorted(points_of)
    T = sorted({pt for _, pt in queries})

    # one linear combination: sum coeff_i C_i - scalar_g G1 - zt_u C_h + u C_w
    lc_points, lc_scalars = [], []
    scalar_g = 0  # coefficient of G1 generator (from the r_i(u) constants)
    vi = 1
    for label in labels:
        S = sorted(set(points_of[label]))
        z_u = 1
        for t in T:
            if t not in S:
                z_u = z_u * ((u_pt - t) % P) % P
        r = lagrange_interp(S, [evals[(label, s)] for s in S])
        coeff = vi * z_u % P
        lc_points.append(commitments[label])
        lc_scalars.append(coeff)
        scalar_g = (scalar_g + coeff * poly_eval(r, u_pt)) % P
        vi = vi * v % P
    zt_u = 1
    for t in T:
        zt_u = zt_u * ((u_pt - t) % P) % P
    lc_points += [ec.G1, c_h, c_w]
    lc_scalars += [(-scalar_g) % P, (-zt_u) % P, u_pt]
    lhs = ec.g1_lincomb(lc_points, lc_scalars)
    return ec.pairing_product_is_one(
        [(lhs, params.g2), (ec.ec_neg(c_w), params.s_g2)]
    )

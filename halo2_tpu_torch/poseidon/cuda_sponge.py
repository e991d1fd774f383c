"""The ``poseidon_hash`` kernel's launch: the batched Poseidon sponge, or
one permutation, in one launch (``csrc/poseidon.cu``), and its constant
table: the full rounds as the spec gives them and the partial rounds in
their exact sparse form (:func:`sparse_form`), with a host model of the
kernel's schedule over that table (:func:`permute_sparse_host`) for tests.

The kernel replaces the reference's three ``lax.scan``s over the rounds
(``halo2_tpu/poseidon/primitives.py:163-224``); ``poseidon/primitives.py``
holds the wrappers (``permute_device``, ``hash_device``), which launch it
for CUDA tensors and run the plain versions for CPU ones.  ``LAUNCHES``
counts its launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.cuda_mul import ARITH, arith, modulus_words
from ..field.device import get_device_field
from ..field.params import NUM_LIMBS, FieldSpec
from .grain import generate_constants

L = NUM_LIMBS
LAUNCHES = {"poseidon_hash": 0}
# the state widths the kernel is instantiated for: P128Pow5T3 (3) and
# MySpec(5, 4) / MySpec(5, 3) (5)
WIDTHS = (3, 5)


def _pack(limbs: np.ndarray) -> np.ndarray:
    """(n, 16) 16-bit limbs -> (n, 8) uint32, the kernel's register layout:
    word k is limb 2k | limb 2k + 1 << 16."""
    u = limbs.astype(np.uint32)
    return np.ascontiguousarray(u[:, 0::2] | u[:, 1::2] << 16)


def _mat_inv(a: list, p: int) -> list:
    """The inverse of the square matrix ``a`` mod p (Gauss-Jordan), or None
    where it is singular."""
    n = len(a)
    m = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for c in range(n):
        piv = next((r for r in range(c, n) if m[r][c] % p), None)
        if piv is None:
            return None
        m[c], m[piv] = m[piv], m[c]
        inv = pow(m[c][c], -1, p)
        m[c] = [v * inv % p for v in m[c]]
        for r in range(n):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(v - f * w) % p for v, w in zip(m[r], m[c])]
    return [row[n:] for row in m]


def _mat_mul(a: list, b: list, p: int) -> list:
    return [[sum(x * y for x, y in zip(row, col)) % p for col in zip(*b)] for row in a]


def _mat_vec(a: list, v: list, p: int) -> list:
    return [sum(x * y for x, y in zip(row, v)) % p for row in a]


def sparse_form(p: int, rcs: list, mds: list, r_f: int, r_p: int, label: str = "") -> dict:
    """Poseidon's partial rounds in the equivalent sparse form (Grassi et
    al., *Poseidon*, USENIX Security 2021, Appendix B; the authors'
    ``calc_equivalent_constants`` / ``calc_equivalent_matrices`` in the
    hadeshash reference scripts), exactly, in Python ints mod p.

    ``rcs`` are the ``2 r_f + r_p`` rounds' constant vectors and ``mds`` the
    W x W matrix M.  The partial block (round q: x <- M S0(x + c_q), S0 the
    S-box on word 0) becomes: x <- x + c_hat, x <- edge x, then per round q
    x0 <- x0^5 + k_q and x <- S_q x, where S_q is one first row ``rows[q]``
    (W entries: new x0 = sum_j row_j x_j) and one first column ``cols[q]``
    (W - 1 entries: new x_i = x_i + col_i x0 with the old x0).

    Constants, folded backward from the last partial round: round q's
    output plus c_(q+1) is M (S0(y) + u) with u = M^-1 c_(q+1); u's words
    1 .. W - 1 pass round q's S-box, so they join c_q, and its word 0 is
    added after that S-box (k_q; k_(r_p - 1) = 0); what c_0 holds at the
    end is c_hat.
    Matrices: with A_(r_p - 1) = M and A = [[a00, a^T], [b, A_hat]],
    A_q = S_q B_q where B_q = [[1, 0], [0, A_hat]] and S_q = [[a00, a^T
    A_hat^-1], [b, I]]; B_q fixes word 0, so it commutes with the S-box and
    the add of round q and joins round q - 1's matrix: A_(q - 1) = B_q M.
    What is left, B_0, is ``edge``.  Every A_hat is asserted invertible
    (it is M_hat^(r_p - q) for M's lower-right block, invertible for a
    Cauchy MDS).  ``blocks`` holds each round's (A_q, S_q, B_q)."""
    W = len(mds)
    c = [list(rcs[r_f + q]) for q in range(r_p)]
    ks = [0] * r_p
    m_inv = _mat_inv(mds, p)
    if m_inv is None:
        raise AssertionError(f"poseidon sparse form {label}: the MDS matrix is singular")
    for q in range(r_p - 1, 0, -1):
        u = _mat_vec(m_inv, c[q], p)
        ks[q - 1] = u[0]
        c[q - 1] = [c[q - 1][0]] + [(c[q - 1][i] + u[i]) % p for i in range(1, W)]
    rows, cols, blocks = [None] * r_p, [None] * r_p, [None] * r_p
    a = [list(row) for row in mds]
    for q in range(r_p - 1, -1, -1):
        a_hat = [row[1:] for row in a[1:]]
        a_hat_inv = _mat_inv(a_hat, p)
        if a_hat_inv is None:
            raise AssertionError(f"poseidon sparse form {label}: round {q}'s lower-right block is singular")
        rows[q] = [a[0][0]] + [sum(a[0][1 + i] * a_hat_inv[i][j] for i in range(W - 1)) % p for j in range(W - 1)]
        cols[q] = [a[i][0] for i in range(1, W)]
        b = [[1] + [0] * (W - 1)] + [[0] + row for row in a_hat]
        s = [list(rows[q])] + [[cols[q][i - 1]] + [int(i == j) for j in range(1, W)] for i in range(1, W)]
        blocks[q] = (a, s, b)
        a = _mat_mul(b, mds, p)
    return {"c_hat": c[0], "ks": ks, "edge": blocks[0][2], "rows": rows, "cols": cols, "blocks": blocks}


def table_layout(width: int, r_f_total: int, r_p: int) -> dict:
    """Row offsets of the kernel's constant table (see ``csrc/poseidon.cu``)
    and its length, in 8-word entries."""
    W, full = width, r_f_total
    lay = {"rc": 0, "c_hat": full * W}
    lay["ks"] = lay["c_hat"] + W
    lay["mds"] = lay["ks"] + r_p
    lay["edge"] = lay["mds"] + W * W
    lay["sparse"] = lay["edge"] + W * W
    lay["rows"] = lay["sparse"] + r_p * (2 * W - 1)
    return lay


def constants_ints(field_spec: FieldSpec, width: int, r_f_total: int, r_p: int, secure_mds: int) -> list:
    """The kernel's constant table as canonical ints (not Montgomery), in
    table order (:func:`table_layout`): the full rounds' constants (round f
    of the 2 r_f word i at f W + i: the first r_f rounds, then the last),
    the partial block's vector constant c_hat, the r_p scalars k_q, the MDS
    matrix (i, j) at i W + j, the edge matrix B_0 likewise, then each
    partial round's sparse matrix: its first row (W entries), then its
    first column below the corner (W - 1)."""
    rcs, mds, _ = generate_constants(field_spec, width, r_f_total, r_p, secure_mds)
    r_f = r_f_total // 2
    sp = sparse_form(field_spec.p, rcs, mds, r_f, r_p, f"{field_spec.name} W={width}")
    full = rcs[:r_f] + rcs[r_f + r_p:]
    out = [v for row in full for v in row] + list(sp["c_hat"]) + list(sp["ks"])
    out += [v for row in mds for v in row] + [v for row in sp["edge"] for v in row]
    for row, col in zip(sp["rows"], sp["cols"]):
        out += list(row) + list(col)
    assert len(out) == table_layout(width, r_f_total, r_p)["rows"]
    return out


def constants_words(field_spec: FieldSpec, width: int, r_f_total: int, r_p: int, secure_mds: int) -> np.ndarray:
    """The kernel's constant table, ``(rows, 8)`` uint32: the entries of
    :func:`constants_ints` in Montgomery form, each as eight little-endian
    words (word k is limb 2k | limb 2k + 1 << 16)."""
    vals = constants_ints(field_spec, width, r_f_total, r_p, secure_mds)
    return _pack(get_device_field(field_spec).encode_np(vals).T)


def unpack_words(field_spec: FieldSpec, words: np.ndarray) -> list:
    """(rows, 8) packed Montgomery words -> canonical ints (the inverse of
    :func:`constants_words`' packing)."""
    r_inv, p = field_spec.r_inv, field_spec.p
    return [
        sum(int(w) << (32 * k) for k, w in enumerate(row)) * r_inv % p for row in np.asarray(words, np.uint32)
    ]


def permute_sparse_host(F, spec, state: list) -> list:
    """The kernel's permutation schedule on the host, in Python ints: the
    packed table (:func:`constants_words`) read back in the kernel's order,
    r_f full rounds (constants, S-boxes, the dense MDS product), the
    partial block in the sparse form (c_hat, the edge matrix, then per
    round one S-box, k_q, a row and a column), r_f full rounds.  ``state``
    is W field elements of host field ``F``; returns W of them.  For tests:
    the kernel runs this schedule on the card."""
    p, W = F.SPEC.p, spec.width
    r_f, r_p = spec.full_rounds() // 2, spec.partial_rounds()
    tab = unpack_words(F.SPEC, constants_words(F.SPEC, W, spec.full_rounds(), r_p, spec.secure_mds()))
    lay = table_layout(W, spec.full_rounds(), r_p)
    mds = [tab[lay["mds"] + i * W: lay["mds"] + (i + 1) * W] for i in range(W)]
    edge = [tab[lay["edge"] + i * W: lay["edge"] + (i + 1) * W] for i in range(W)]
    x = [int(v) % p for v in state]

    def full_round(f):
        y = [pow((v + tab[lay["rc"] + f * W + i]) % p, 5, p) for i, v in enumerate(x)]
        return _mat_vec(mds, y, p)

    for f in range(r_f):
        x = full_round(f)
    x = _mat_vec(edge, [(v + tab[lay["c_hat"] + i]) % p for i, v in enumerate(x)], p)
    for q in range(r_p):
        base = lay["sparse"] + q * (2 * W - 1)
        row, col = tab[base: base + W], tab[base + W: base + 2 * W - 1]
        x0 = (pow(x[0], 5, p) + tab[lay["ks"] + q]) % p
        new0 = (row[0] * x0 + sum(r * v for r, v in zip(row[1:], x[1:]))) % p
        x = [new0] + [(v + c * x0) % p for v, c in zip(x[1:], col)]
    for f in range(r_f, 2 * r_f):
        x = full_round(f)
    return [F(v) for v in x]


@functools.lru_cache(maxsize=None)
def _table(field_spec: FieldSpec, width: int, r_f_total: int, r_p: int, secure_mds: int, device) -> torch.Tensor:
    """:func:`constants_words` on ``device`` as int32, made once per field,
    spec and device."""
    words = constants_words(field_spec, width, r_f_total, r_p, secure_mds)
    return torch.from_numpy(words.view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _capacity_words(field_spec: FieldSpec, n_msg: int) -> np.ndarray:
    """ConstantLength<n_msg>'s capacity word n_msg 2^64 in Montgomery form,
    eight words."""
    return _pack(get_device_field(field_spec).encode_np([n_msg << 64]).T)[0]


def launch(field_spec: FieldSpec, spec, inp: torch.Tensor, n_msg: int, hash_mode: bool) -> torch.Tensor:
    """One ``poseidon_hash`` launch on ``inp``'s CUDA device: with
    ``hash_mode`` the ConstantLength<n_msg> digests ``(16, B)`` of messages
    ``(n_msg, 16, B)``, else one permutation of states ``(W, 16, B)``.
    ``inp`` is contiguous int32 Montgomery limbs; the caller has checked
    the shapes."""
    from .. import _build

    width = spec.width
    if width not in WIDTHS:
        raise ValueError(f"poseidon_hash: the kernel takes widths {WIDTHS}, got {width}")
    B = inp.shape[-1]
    out = torch.empty((L, B) if hash_mode else (width, L, B), dtype=torch.int32, device=inp.device)
    if B == 0:
        return out
    table = _table(field_spec, width, spec.full_rounds(), spec.partial_rounds(), spec.secure_mds(), inp.device)
    cap = _capacity_words(field_spec, n_msg if hash_mode else 0)
    _build.launch(
        "poseidon_hash", inp.device, inp.data_ptr(), out.data_ptr(), B, n_msg if hash_mode else width,
        int(hash_mode), width, table.data_ptr(), spec.full_rounds() // 2, spec.partial_rounds(),
        modulus_words(field_spec).ctypes.data, cap.ctypes.data, ARITH[arith(field_spec)],
    )
    LAUNCHES["poseidon_hash"] += 1
    return out

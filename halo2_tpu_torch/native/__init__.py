"""Native host engine bindings (ctypes over engine.cc).

The reference's host-side heavy lifting is native Rust (halo2curves field and
curve arithmetic, halo2_proofs poly ops — SURVEY.md §2c); this package is the
C++ equivalent for the TPU framework's host tail: small-n MSM commits (where
XLA program setup would dominate the actual compute by orders of magnitude),
NTTs, batch inversion, grand-product recurrences and Horner evaluations.

Array convention at this boundary: (4, n) or (n, 4) is NOT used — elements
are packed as contiguous little-endian 4x u64 rows, i.e. a numpy uint64
array of shape (n, 4).  Helpers convert from the repo's device convention
((16, n) uint32 of 16-bit limbs) with pure-numpy bit arithmetic.

The shared library is compiled on demand with g++ -O3 (no external deps) and
cached next to the source, keyed by a source hash.  If no compiler is
available, ``available()`` returns False and callers fall back to the
JAX/host-int paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "engine.cc")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _isa_tag() -> str:
    """Host ISA fingerprint folded into the cached .so name: the build uses
    -march=native, so a repo dir shared between machines (NFS, copies) must
    not dlopen a binary built for another CPU's feature set."""
    import platform

    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags") or line.startswith("Features"):
                    feats = "".join(sorted(line.split(":", 1)[1].split()))
                    tag += "-" + hashlib.sha256(feats.encode()).hexdigest()[:8]
                    break
    except OSError:
        pass
    return tag


def _build() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_DIR, f"_engine_{digest}_{_isa_tag()}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-std=c++17",
        "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("HALO2_TPU_NO_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(_build())
        except Exception:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.h2t_set_threads.argtypes = [ctypes.c_int]
        lib.h2t_to_mont.argtypes = [ctypes.c_int, u64p, ctypes.c_size_t]
        lib.h2t_from_mont.argtypes = [ctypes.c_int, u64p, ctypes.c_size_t]
        lib.h2t_mul.argtypes = [ctypes.c_int, u64p, u64p, u64p, ctypes.c_size_t]
        lib.h2t_msm_g1.argtypes = [u64p, u64p, u64p, ctypes.c_size_t, u64p]
        lib.h2t_msm_g1_mont.argtypes = [u64p, u64p, u64p, ctypes.c_size_t, u64p]
        lib.h2t_msm_g1_mont_batch.argtypes = [
            u64p, u64p, u64p, ctypes.c_size_t, ctypes.c_size_t, u64p,
        ]
        lib.h2t_points_to52.argtypes = [u64p, u64p, ctypes.c_size_t, u64p, u64p]
        lib.h2t_points_to52.restype = ctypes.c_int
        lib.h2t_msm_g1_mont52.argtypes = [u64p, u64p, u64p, ctypes.c_size_t, u64p]
        lib.h2t_msm_g1_mont52.restype = ctypes.c_int
        lib.h2t_ntt_fr.argtypes = [u64p, ctypes.c_size_t, ctypes.c_int]
        lib.h2t_ntt_fr_batch.argtypes = [
            u64p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.h2t_scale_row_fr_batch.argtypes = [
            u64p, ctypes.c_size_t, ctypes.c_size_t, u64p,
        ]
        lib.h2t_coset_ntt_fr_batch.argtypes = [
            u64p, ctypes.c_size_t, ctypes.c_size_t, u64p, ctypes.c_size_t, u64p,
        ]
        lib.h2t_scale_powers_fr.argtypes = [u64p, ctypes.c_size_t, u64p]
        lib.h2t_batch_inv_fr.argtypes = [u64p, ctypes.c_size_t]
        lib.h2t_grand_product_fr.argtypes = [
            u64p, u64p, ctypes.c_size_t, u64p, u64p,
        ]
        lib.h2t_poly_eval_fr.argtypes = [
            u64p, ctypes.c_size_t, u64p, ctypes.c_size_t, u64p,
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.h2t_expr_eval_fr.argtypes = [
            u64p, ctypes.c_size_t, ctypes.c_size_t,
            i32p, ctypes.c_size_t, i32p, ctypes.c_size_t, u64p,
        ]
        lib.h2t_axpy_fr.argtypes = [u64p, u64p, u64p, ctypes.c_size_t]
        lib.h2t_fold_scaled_fr.argtypes = [
            u64p, ctypes.c_size_t, ctypes.c_size_t, u64p, u64p,
        ]
        lib.h2t_poly_div_fr.argtypes = [
            u64p, ctypes.c_size_t, u64p, ctypes.c_size_t,
        ]
        lib.h2t_poly_div_fr.restype = ctypes.c_int
        lib.h2t_expr_eval_fr_rows.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), i32p, i32p,
            ctypes.c_size_t, ctypes.c_size_t,
            i32p, ctypes.c_size_t, i32p, ctypes.c_size_t, u64p,
        ]
        lib.h2t_pairing_product_is_one.argtypes = [
            u64p, ctypes.c_size_t, u64p, ctypes.c_size_t,
        ]
        lib.h2t_pairing_product_is_one.restype = ctypes.c_int
        lib.h2t_pairing.argtypes = [u64p, u64p, u64p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# ----------------------------------------------------------- packing helpers
def pack_device(limbs16) -> np.ndarray:
    """(16, n) uint32 16-bit limb array (device convention, any form) ->
    (n, 4) uint64 element rows, same 256-bit integers.

    Little-endian limb order means the packing is just a uint16 transpose
    reinterpreted as u64 words (~11x the shift/or loop it replaces)."""
    a = np.asarray(limbs16)
    n = a.shape[1] if a.ndim > 1 else 1
    a = a.reshape(16, n).astype(np.uint16)  # values are 16-bit by convention
    return np.ascontiguousarray(a.T).view(np.uint64)  # (n, 4)


def unpack_device(words: np.ndarray) -> np.ndarray:
    """(n, 4) uint64 -> (16, n) uint32 16-bit limbs."""
    w = np.ascontiguousarray(words).T  # (4, n)
    out = np.empty((16, w.shape[1]), np.uint32)
    for j in range(16):
        out[j] = ((w[j // 4] >> np.uint64(16 * (j % 4))) & np.uint64(0xFFFF)).astype(
            np.uint32
        )
    return out


def pack_ints(vals) -> np.ndarray:
    """Iterable of Python ints (< 2^256) -> (n, 4) uint64."""
    out = np.empty((len(vals), 4), np.uint64)
    m = (1 << 64) - 1
    for i, v in enumerate(vals):
        v = int(v)
        out[i, 0] = v & m
        out[i, 1] = (v >> 64) & m
        out[i, 2] = (v >> 128) & m
        out[i, 3] = (v >> 192) & m
    return out


def unpack_ints(words: np.ndarray) -> list:
    w = np.asarray(words, dtype=np.uint64).reshape(-1, 4)
    return [
        int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192
        for r in w
    ]


# ------------------------------------------------------------------ wrappers
def set_threads(n: int):
    lib = _load()
    if lib:
        lib.h2t_set_threads(int(n))


def from_mont(words: np.ndarray, field: str = "fr") -> np.ndarray:
    """In-place-free canonicalization of (n, 4) Montgomery-form elements."""
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64).copy()
    lib.h2t_from_mont(0 if field == "fr" else 1, _ptr(a), a.shape[0])
    return a


def to_mont(words: np.ndarray, field: str = "fr") -> np.ndarray:
    """(n, 4) canonical -> Montgomery form."""
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64).copy()
    lib.h2t_to_mont(0 if field == "fr" else 1, _ptr(a), a.shape[0])
    return a


def mul_fr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise c[i] = a[i]*b[i] mod r over (n, 4) canonical arrays."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    c = np.zeros_like(a)
    lib.h2t_mul(0, _ptr(a), _ptr(b), _ptr(c), a.shape[0])
    return c


def msm_g1_mont(px_m: np.ndarray, py_m: np.ndarray, scalars: np.ndarray):
    """MSM over BN254 G1.  px_m/py_m: (n, 4) u64 MONTGOMERY affine coords
    ((0,0) rows = infinity); scalars: (n, 4) u64 canonical Fr.
    Returns host ints (x, y), (0, 0) = infinity."""
    lib = _load()
    n = px_m.shape[0]
    out = np.zeros(8, np.uint64)
    px_m = np.ascontiguousarray(px_m, dtype=np.uint64)
    py_m = np.ascontiguousarray(py_m, dtype=np.uint64)
    scalars = np.ascontiguousarray(scalars, dtype=np.uint64)
    lib.h2t_msm_g1_mont(_ptr(px_m), _ptr(py_m), _ptr(scalars), n, _ptr(out))
    xy = unpack_ints(out)
    return xy[0], xy[1]


def points_to52(px_m: np.ndarray, py_m: np.ndarray):
    """Precompute the IFMA Pippenger's Montgomery-52 lane form of a fixed
    point set (e.g. the SRS, reused across every commit of a prove).
    px_m/py_m: (n, 4) u64 Montgomery affine ((0,0) = infinity).
    Returns (px52, py52) as (n, 5) u64, or None without IFMA support."""
    lib = _load()
    px_m = np.ascontiguousarray(px_m, dtype=np.uint64)
    py_m = np.ascontiguousarray(py_m, dtype=np.uint64)
    n = px_m.shape[0]
    px52 = np.empty((n, 5), np.uint64)
    py52 = np.empty((n, 5), np.uint64)
    if lib.h2t_points_to52(_ptr(px_m), _ptr(py_m), n, _ptr(px52), _ptr(py52)):
        return None
    return px52, py52


def msm_g1_mont52(px52: np.ndarray, py52: np.ndarray, scalars: np.ndarray):
    """MSM over points precomputed by points_to52; scalars (n, 4) canonical.
    Returns host ints (x, y), or None without IFMA support."""
    lib = _load()
    n = px52.shape[0]
    out = np.zeros(8, np.uint64)
    scalars = np.ascontiguousarray(scalars, dtype=np.uint64)
    if lib.h2t_msm_g1_mont52(_ptr(px52), _ptr(py52), _ptr(scalars), n, _ptr(out)):
        return None
    xy = unpack_ints(out)
    return xy[0], xy[1]


def msm_g1_mont_batch(px_m: np.ndarray, py_m: np.ndarray, scalars_b: np.ndarray):
    """Batched MSM: scalars_b (nb, n, 4) canonical over shared points.
    Returns list of host-int (x, y) pairs."""
    lib = _load()
    nb, n = scalars_b.shape[0], scalars_b.shape[1]
    out = np.zeros((nb, 8), np.uint64)
    px_m = np.ascontiguousarray(px_m, dtype=np.uint64)
    py_m = np.ascontiguousarray(py_m, dtype=np.uint64)
    scalars_b = np.ascontiguousarray(scalars_b, dtype=np.uint64)
    lib.h2t_msm_g1_mont_batch(
        _ptr(px_m), _ptr(py_m), _ptr(scalars_b), n, nb, _ptr(out)
    )
    res = []
    for b in range(nb):
        xy = unpack_ints(out[b])
        res.append((xy[0], xy[1]))
    return res


def ntt_fr(words: np.ndarray, inverse: bool = False) -> np.ndarray:
    """(n, 4) canonical Fr -> NTT (natural order in/out, matches
    poly.domain._ntt_fn)."""
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64).copy()
    lib.h2t_ntt_fr(_ptr(a), a.shape[0], 1 if inverse else 0)
    return a


def ntt_fr_batch(words: np.ndarray, inverse: bool = False) -> np.ndarray:
    """(nb, n, 4) canonical Fr -> per-column NTT (threads over columns)."""
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64).copy()
    lib.h2t_ntt_fr_batch(_ptr(a), a.shape[0], a.shape[1], 1 if inverse else 0)
    return a


def scale_row_fr_batch(words: np.ndarray, row: np.ndarray) -> np.ndarray:
    """(nb, n, 4) canonical; multiply every column elementwise by row (n, 4)."""
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64).copy()
    row = np.ascontiguousarray(row, dtype=np.uint64)
    lib.h2t_scale_row_fr_batch(_ptr(a), a.shape[0], a.shape[1], _ptr(row))
    return a


def coset_ntt_fr_batch(words: np.ndarray, ext_n: int, coset_row: np.ndarray) -> np.ndarray:
    """Fused pad + coset-scale + forward NTT: (nb, n_in, 4) canonical columns
    -> (nb, ext_n, 4).  coset_row: (ext_n, 4) canonical scale factors."""
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64)
    nb, n_in = a.shape[0], a.shape[1]
    out = np.empty((nb, ext_n, 4), np.uint64)
    row = np.ascontiguousarray(coset_row, dtype=np.uint64)
    lib.h2t_coset_ntt_fr_batch(_ptr(a), nb, n_in, _ptr(out), ext_n, _ptr(row))
    return out


def scale_powers_fr(words: np.ndarray, g: int) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64).copy()
    gv = pack_ints([g])[0].copy()
    lib.h2t_scale_powers_fr(_ptr(a), a.shape[0], _ptr(gv))
    return a


def batch_inv_fr(words: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(words, dtype=np.uint64).copy()
    lib.h2t_batch_inv_fr(_ptr(a), a.shape[0])
    return a


def grand_product_fr(num: np.ndarray, den: np.ndarray, carry: int) -> np.ndarray:
    """z[0] = carry; z[r+1] = z[r]*num[r]/den[r].  num/den (u, 4) canonical;
    returns (u+1, 4) canonical."""
    lib = _load()
    u = num.shape[0]
    num = np.ascontiguousarray(num, dtype=np.uint64)
    den = np.ascontiguousarray(den, dtype=np.uint64)
    cv = pack_ints([carry])[0].copy()
    out = np.zeros((u + 1, 4), np.uint64)
    lib.h2t_grand_product_fr(_ptr(num), _ptr(den), u, _ptr(cv), _ptr(out))
    return out


def expr_eval_fr(base: np.ndarray, instrs: np.ndarray, out_slots, n: int) -> np.ndarray:
    """Run a plonkish/evaluator.Program natively.

    base: (nbase, n, 4) u64 canonical rows (pre-rotated queries + constants);
    instrs: (ni, 4) int32 [op, s1, s2, dst]; out_slots: iterable of buffer
    slots to gather.  Returns (nout, n, 4) canonical."""
    lib = _load()
    base = np.ascontiguousarray(base, dtype=np.uint64)
    nbase = base.shape[0]
    instrs = np.ascontiguousarray(instrs, dtype=np.int32).reshape(-1, 4)
    slots = np.ascontiguousarray(np.asarray(out_slots, dtype=np.int32))
    nout = slots.shape[0]
    out = np.zeros((nout, n, 4), np.uint64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.h2t_expr_eval_fr(
        _ptr(base), nbase, n,
        instrs.ctypes.data_as(i32), instrs.shape[0],
        slots.ctypes.data_as(i32), nout, _ptr(out),
    )
    return out


def axpy_fr_inplace(acc: np.ndarray, b: np.ndarray, s: int) -> None:
    """acc[:len(b)] += b*s in place; acc must be a C-contiguous uint64 view."""
    lib = _load()
    assert acc.flags.c_contiguous and acc.dtype == np.uint64
    bb = np.ascontiguousarray(b, dtype=np.uint64)
    from ..field.params import BN254_FR

    sv = pack_ints([int(s) % BN254_FR.p])[0].copy()
    n = min(acc.shape[0], bb.shape[0])
    lib.h2t_axpy_fr(_ptr(acc), _ptr(bb), _ptr(sv), n)


def axpy_fr(acc: np.ndarray, b: np.ndarray, s: int) -> np.ndarray:
    """acc + b*s over (n, 4) canonical arrays (returns a new array)."""
    a = np.ascontiguousarray(acc, dtype=np.uint64).copy()
    axpy_fr_inplace(a, b, s)
    return a


def fold_scaled_fr(rows: np.ndarray, factors: list) -> np.ndarray:
    """sum_i rows[i] * factors[i] over (nh, n, 4) canonical rows."""
    lib = _load()
    r = np.ascontiguousarray(rows, dtype=np.uint64)
    f = pack_ints([int(x) for x in factors])
    out = np.zeros((r.shape[1], 4), np.uint64)
    lib.h2t_fold_scaled_fr(_ptr(r), r.shape[0], r.shape[1], _ptr(f), _ptr(out))
    return out


def poly_div_fr(f: np.ndarray, divisor: list) -> np.ndarray:
    """Exact polynomial division over (nf, 4) canonical coeffs by a small
    int-list divisor; raises on non-zero remainder."""
    lib = _load()
    a = np.ascontiguousarray(f, dtype=np.uint64).copy()
    d = pack_ints([int(c) for c in divisor])
    rem = lib.h2t_poly_div_fr(_ptr(a), a.shape[0], _ptr(d), d.shape[0])
    if rem:
        raise AssertionError("non-zero remainder in native poly division")
    out_len = max(a.shape[0] - (d.shape[0] - 1), 1)
    return a[:out_len]


_FINAL_EXP_WORDS = None


def _final_exp_words() -> np.ndarray:
    """(p^12 - 1) / r as little-endian u64 words (computed once host-side;
    the C++ side exponentiates by whatever words it is given)."""
    global _FINAL_EXP_WORDS
    if _FINAL_EXP_WORDS is None:
        from ..field.params import BN254_FQ, BN254_FR

        e = (BN254_FQ.p**12 - 1) // BN254_FR.p
        words = []
        while e:
            words.append(e & ((1 << 64) - 1))
            e >>= 64
        _FINAL_EXP_WORDS = np.array(words, np.uint64)
    return _FINAL_EXP_WORDS


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 over BN254.  pairs: iterable of
    ((px, py), ((qx0, qx1), (qy0, qy1))) host ints, canonical; (0, 0) /
    all-zero marks infinity (skipped).  Native optimal-ate + single final
    exponentiation — the verifier hot path (reference verify_proof,
    src/circuits/utils.rs:56-63)."""
    lib = _load()
    flat = []
    for (px, py), ((qx0, qx1), (qy0, qy1)) in pairs:
        flat.extend([px, py, qx0, qx1, qy0, qy1])
    arr = pack_ints(flat).reshape(-1)
    e = np.ascontiguousarray(_final_exp_words())
    r = lib.h2t_pairing_product_is_one(
        _ptr(arr), len(flat) // 6, _ptr(e), e.shape[0]
    )
    return r == 1


def miller_loop_direct(p_xy, q_xyxy) -> list:
    """Miller loop (no final exp) -> 12 direct-basis FQ12 coefficients
    (host ints) for cross-checking against ec/host.py.  p_xy = (px, py),
    q_xyxy = ((qx0, qx1), (qy0, qy1)), canonical ints."""
    lib = _load()
    p = pack_ints(list(p_xy)).reshape(-1)
    q = pack_ints([q_xyxy[0][0], q_xyxy[0][1], q_xyxy[1][0], q_xyxy[1][1]]).reshape(-1)
    out = np.zeros(48, np.uint64)
    lib.h2t_pairing(_ptr(p), _ptr(q), _ptr(out))
    return unpack_ints(out.reshape(12, 4))


def expr_eval_fr_rows(rows, rots, strides, instrs: np.ndarray, out_slots, n: int) -> np.ndarray:
    """Zero-copy Program evaluation: rows is a list of (m, 4) u64 canonical
    arrays read in place (m == n, or m == 1 with strides[b] == 0 for a
    broadcast constant); rots[b] rotates row b by +rot (value i reads
    src[(i + rot) % n]).  Returns (nout, n, 4) canonical."""
    lib = _load()
    nbase = len(rows)
    keepalive = [np.ascontiguousarray(r, dtype=np.uint64) for r in rows]
    ptrs = (ctypes.c_void_p * nbase)(
        *[r.ctypes.data_as(ctypes.c_void_p).value for r in keepalive]
    )
    rots_a = np.ascontiguousarray(np.asarray(rots, dtype=np.int32))
    strides_a = np.ascontiguousarray(np.asarray(strides, dtype=np.int32))
    instrs = np.ascontiguousarray(instrs, dtype=np.int32).reshape(-1, 4)
    slots = np.ascontiguousarray(np.asarray(out_slots, dtype=np.int32))
    nout = slots.shape[0]
    out = np.zeros((nout, n, 4), np.uint64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.h2t_expr_eval_fr_rows(
        ptrs,
        rots_a.ctypes.data_as(i32), strides_a.ctypes.data_as(i32),
        nbase, n,
        instrs.ctypes.data_as(i32), instrs.shape[0],
        slots.ctypes.data_as(i32), nout, _ptr(out),
    )
    return out


def poly_eval_fr(poly: np.ndarray, xs: list) -> list:
    """Evaluate one poly ((n, 4) canonical coeffs) at each x in xs."""
    lib = _load()
    poly = np.ascontiguousarray(poly, dtype=np.uint64)
    xv = pack_ints([int(x) for x in xs])
    out = np.zeros((len(xs), 4), np.uint64)
    lib.h2t_poly_eval_fr(_ptr(poly), poly.shape[0], _ptr(xv), len(xs), _ptr(out))
    return unpack_ints(out)

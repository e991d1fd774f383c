"""KZG prover (halo2 `create_proof` with ProverSHPLONK) on torch tensors —
port of halo2_tpu/kzg/prover.py.

The reference's phase order and code, with the engine chosen by
``engine=`` (the reference reads ``HALO2_TPU_PROVER_BACKEND``) and an
explicit ``device``:
  synthesize -> commit advice -> theta -> lookup permuted columns -> beta,
  gamma -> permutation / lookup grand products -> random poly -> y -> quotient
  h(X) on the extended coset -> x -> evaluations -> SHPLONK multiopen.

On :class:`.engine.TorchEngine` (the default) the row-axis work (iNTTs,
coset NTTs, the quotient instruction VM, the vanishing multiply,
``extended_to_coeff``) runs on ``device``; grand products and the multiopen
run on the host, as in the reference's device engine, and the commitments
where ``commit`` says.  On :class:`.engine.NativeEngine` all of it runs on
the native C++ host engine.  With ``mesh=`` the row-axis phases are split
over the ranks of a process group (:class:`.engine.ShardedEngine`).  For the
same ``rng`` the proof bytes equal the reference's on every engine.
"""

from __future__ import annotations

import os
import random as _random
import time
from collections import Counter

import numpy as np
import torch

from .._device import resolve_device
from ..field.params import BN254_FR
from ..plonkish.assignment import run_synthesis
from ..plonkish.column import Column, ColumnKind, Rotation
from ..plonkish.expression import Query
from .engine import ShardedEngine, select_engine
from .expr_eval import eval_expr_rows
from .keygen import ProvingKey, _horner
from .shplonk import shplonk_open
from .transcript import Blake2bWrite

P = BN254_FR.p


PHASE_TIMINGS: dict = {}


def _phase(name, t0, eng):
    """Add the time since t0 to PHASE_TIMINGS[name]; when ``eng`` works on a
    CUDA device, after waiting for the work queued so far, so the time is
    the phase's own."""
    device = getattr(eng, "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    PHASE_TIMINGS[name] = PHASE_TIMINGS.get(name, 0.0) + dt
    if os.environ.get("HALO2_TPU_TIMING"):
        print(f"  [prover] {name}: {dt:.2f}s", flush=True)
    return time.perf_counter()


def _native_or_none():
    from .. import native

    return native if native.available() else None


def create_proof(
    params, pk: ProvingKey, circuit, instances, rng=None, device=None, commit="native", engine="torch", mesh=None
) -> bytes:
    """halo2 `create_proof` (reference src/circuits/utils.rs:40-48).

    ``engine="torch"`` (the default): the row-axis work on ``device`` (a
    torch device; the CUDA device when None, and without a card it raises)
    and the commitments on the native host Pippenger (``commit="native"``)
    or the device Pippenger on ``device`` (``commit="device"``).
    ``engine="native"``: the whole prove on the native C++ host engine, no
    card needed.  ``engine="auto"``: the reference's rule
    (:func:`.engine.select_engine`), native at or below
    ``engine.DEVICE_MIN_EXT`` extended-domain points.

    The reference defaults to its rule, which picks the host engine for the
    flagship; this port defaults to the card, so that a caller who names no
    engine proves on the GPU and a missing card shows.

    ``mesh``: a ``(dp, sp)`` DeviceMesh (:func:`..parallel.make_mesh`) over
    an initialized process group.  Every rank calls ``create_proof`` with
    the same arguments and its own equal ``rng``; the row-axis phases are
    split over the ranks (:class:`.engine.ShardedEngine`, on ``device`` or
    the rank's own device), every commitment runs on the sharded device MSM
    whatever ``commit`` says, and every rank returns the single-device
    proof bytes.  With ``engine="native"`` it raises: the host engine has no
    sharded form."""
    rng = rng or _random.Random()
    if mesh is not None and engine == "native":
        raise ValueError("create_proof: mesh= proves on ShardedEngine; engine='native' has no sharded form")
    if engine == "torch" and mesh is None:
        device = resolve_device(device)  # before any work: a missing card shows at once
    t = time.perf_counter()
    st = pk.vk.structure
    cs, k, n, u = st.cs, st.k, st.n, st.u
    domain = st.domain
    if mesh is not None:
        eng = ShardedEngine(params, st, mesh, device)
    else:
        eng = select_engine(params, st, device, engine=engine, commit=commit)
    if os.environ.get("HALO2_TPU_TIMING"):
        print(f"  [prover] engine: {eng.name}", flush=True)
    transcript = Blake2bWrite()
    transcript.common_scalar(pk.vk.digest)

    # ---------------------------------------------------------- synthesize
    from ..field.host import Fr

    _cs2, _cfg, assignment = run_synthesis(
        circuit, k, instances, witness=True, field=Fr
    )
    fin = assignment.finalize()
    t = _phase("synthesize", t, eng)

    for col in fin.instance:
        for v in col:
            transcript.common_scalar(v)

    # ------------------------------------------------- advice (blinded rows)
    advice_values = []
    for col in fin.advice:
        vals = list(col)
        for r in range(u, n):
            vals[r] = rng.randrange(P)
        advice_values.append(vals)

    advice_coeffs = [eng.to_coeffs(v) for v in advice_values]
    if advice_coeffs:
        for pt in eng.commit_batch(advice_coeffs):
            transcript.write_point(pt)

    t = _phase("advice_commit", t, eng)
    theta = int(transcript.squeeze_challenge())

    # host column table for per-row evaluation
    host_cols = {
        "advice": advice_values,
        "fixed": [list(c) for c in fin.fixed],
        "instance": [list(c) for c in fin.instance],
        "selector": [list(s) for s in fin.selectors],
    }

    # ------------------------------------------------- lookups: permute cols
    aux_theta = {("aux", st.aux.THETA): theta}
    lookup_data = []
    for lk in cs.lookups:
        a_expr = _horner([p_[0] for p_ in lk.pairs], _aux_query(st.aux.THETA))
        s_expr = _horner([p_[1] for p_ in lk.pairs], _aux_query(st.aux.THETA))
        a_vals = [int(v) for v in eval_expr_rows(a_expr, host_cols, n, u, aux_theta)]
        s_vals = [int(v) for v in eval_expr_rows(s_expr, host_cols, n, u, aux_theta)]
        ap = sorted(a_vals)
        leftover = Counter(s_vals)
        sp = [None] * u
        for i, v in enumerate(ap):
            if i == 0 or ap[i] != ap[i - 1]:
                if leftover[v] == 0:
                    raise ValueError("lookup input not contained in table")
                leftover[v] -= 1
                sp[i] = v
        fill = iter([v for v, cnt in leftover.items() for _ in range(cnt)])
        for i in range(u):
            if sp[i] is None:
                sp[i] = next(fill)
        ap_full = ap + [rng.randrange(P) for _ in range(n - u)]
        sp_full = sp + [rng.randrange(P) for _ in range(n - u)]
        lookup_data.append(
            {"a": a_vals, "s": s_vals, "ap": ap_full, "sp": sp_full}
        )

    lookup_perm_coeffs = []
    for ld in lookup_data:
        ld["ap_coeffs"] = eng.to_coeffs(ld["ap"])
        ld["sp_coeffs"] = eng.to_coeffs(ld["sp"])
        lookup_perm_coeffs += [ld["ap_coeffs"], ld["sp_coeffs"]]
    if lookup_perm_coeffs:
        for pt in eng.commit_batch(lookup_perm_coeffs):
            transcript.write_point(pt)

    t = _phase("lookup_permute", t, eng)
    beta = int(transcript.squeeze_challenge())
    gamma = int(transcript.squeeze_challenge())

    # -------------------------------------------- permutation grand products
    delta_pows, omegas = _perm_labels(st)
    perm_cols = cs.permutation_columns
    perm_z_values = []
    carry = 1
    global_idx = 0
    omega_arr = np.array(omegas[:u], dtype=object)
    for cols in st.perm_chunks:
        # vectorized over rows: one object-array op per column instead of a
        # per-row Python loop (round-2 hot spot)
        num_a = np.ones(u, dtype=object)
        den_a = np.ones(u, dtype=object)
        for ci, col in enumerate(cols):
            v = np.array(host_cols[col.kind.value][col.index][:u], dtype=object)
            gi = global_idx + ci
            lbl = (beta * delta_pows[gi] % P) * omega_arr
            num_a = num_a * ((v + lbl + gamma) % P) % P
            sig = np.array(pk.sigma_values[gi][:u], dtype=object)
            den_a = den_a * ((v + beta * sig + gamma) % P) % P
        zh = eng.grand_product_z(num_a, den_a, carry)
        carry = zh[u]
        z = zh[: u + 1] + [rng.randrange(P) for _ in range(n - u - 1)]
        perm_z_values.append(z)
        global_idx += len(cols)

    perm_z_coeffs = [eng.to_coeffs(z) for z in perm_z_values]
    if perm_z_coeffs:
        for pt in eng.commit_batch(perm_z_coeffs):
            transcript.write_point(pt)

    # ------------------------------------------------ lookup grand products
    lookup_z_coeffs = []
    for ld in lookup_data:
        ap_a = np.array(ld["ap"][:u], dtype=object)
        sp_a = np.array(ld["sp"][:u], dtype=object)
        dens = (ap_a + beta) % P * ((sp_a + gamma) % P) % P
        a_a = np.array(ld["a"][:u], dtype=object)
        s_a = np.array(ld["s"][:u], dtype=object)
        nums = (a_a + beta) % P * ((s_a + gamma) % P) % P
        zh = eng.grand_product_z(nums, dens, 1)
        z = zh[: u + 1] + [rng.randrange(P) for _ in range(n - u - 1)]
        ld["z"] = z
        ld["z_coeffs"] = eng.to_coeffs(z)
        lookup_z_coeffs.append(ld["z_coeffs"])
    if lookup_z_coeffs:
        for pt in eng.commit_batch(lookup_z_coeffs):
            transcript.write_point(pt)

    t = _phase("grand_products", t, eng)
    # ------------------------------------------------------ vanishing random
    random_poly = [rng.randrange(P) for _ in range(n)]
    random_coeffs = eng.coeffs_from_values(random_poly)  # already coefficient form
    transcript.write_point(eng.commit_batch([random_coeffs])[0])

    t = _phase("random_poly", t, eng)
    y = int(transcript.squeeze_challenge())

    # ----------------------------------------------------- quotient on coset
    ext_n = domain.extended_n
    rot_scale = ext_n // n

    instance_coeffs = [eng.to_coeffs(list(c)) for c in fin.instance]

    # every column headed to the coset: pad + coset-scale + NTT
    n_fx, n_sel = len(fin.fixed), len(fin.selectors)
    jobs = list(advice_coeffs)
    jobs += [eng.pk_coeff(pk, "fixed", i) for i in range(n_fx + n_sel)]
    jobs += instance_coeffs
    jobs += perm_z_coeffs
    for ld in lookup_data:
        jobs += [ld["ap_coeffs"], ld["sp_coeffs"], ld["z_coeffs"]]
    jobs += [eng.pk_coeff(pk, "sigma", gi) for gi in range(len(perm_cols))]
    exts = eng.coeff_to_extended_many(jobs)

    def take(k):
        nonlocal exts
        out, exts = exts[:k], exts[k:]
        return out

    advice_ext = take(len(advice_coeffs))
    fixed_ext = take(n_fx)
    selector_ext = take(n_sel)
    instance_ext = take(len(instance_coeffs))
    perm_z_ext = take(len(perm_z_coeffs))
    aux_ext = _aux_extended(eng, st, beta, gamma, theta, y)
    for c, ze in enumerate(perm_z_ext):
        aux_ext[st.aux.perm_z(c)] = ze
    for i in range(len(lookup_data)):
        ap_e, sp_e, z_e = take(3)
        aux_ext[st.aux.lookup_permuted_input(i)] = ap_e
        aux_ext[st.aux.lookup_permuted_table(i)] = sp_e
        aux_ext[st.aux.lookup_z(i)] = z_e
    for gi, se in enumerate(take(len(perm_cols))):
        aux_ext[st._sigma_aux_index(gi)] = se

    columns_ext = {
        "advice": advice_ext,
        "fixed": fixed_ext,
        "instance": instance_ext,
        "selector": selector_ext,
        "aux": [aux_ext[i] for i in range(st.num_aux_total)],
    }

    num_ext = eng.quotient_eval(columns_ext, st.combined_quotient(), rot_scale)
    h_ext = eng.mul_ext(num_ext, eng.vanishing_inv_extended())
    h_coeffs_full = eng.extended_to_coeff(h_ext)

    h_pieces = [
        eng.slice_coeffs(h_coeffs_full, i * n, (i + 1) * n) for i in range(ext_n // n)
    ]
    for pt in eng.commit_batch(h_pieces):
        transcript.write_point(pt)

    t = _phase("quotient", t, eng)
    x = int(transcript.squeeze_challenge())

    # ------------------------------------------------------------ evaluations
    # batch every registered poly into ONE decode (one device -> host copy)
    reg_list = [(("advice", i), c) for i, c in enumerate(advice_coeffs)]
    reg_list += [
        (("fixed", i), eng.pk_coeff(pk, "fixed", i))
        for i in range(len(pk.fixed_values))
    ]  # includes selectors
    reg_list += [
        (("sigma", i), eng.pk_coeff(pk, "sigma", i)) for i in range(len(perm_cols))
    ]
    reg_list += [(("perm_z", c), zc) for c, zc in enumerate(perm_z_coeffs)]
    for i, ld in enumerate(lookup_data):
        reg_list += [
            (("lookup_ap", i), ld["ap_coeffs"]),
            (("lookup_sp", i), ld["sp_coeffs"]),
            (("lookup_z", i), ld["z_coeffs"]),
        ]
    reg_list += [(("h_piece", i), piece) for i, piece in enumerate(h_pieces)]
    decoded = eng.decode_many([arr for _, arr in reg_list])

    # host-poly convention: values are (n, 4) u64 canonical numpy arrays on
    # the native engine, Python int lists otherwise (see _hp helpers)
    polys = {}
    n_h = len(h_pieces)
    for (label, _), row in zip(reg_list[: len(reg_list) - n_h], decoded):
        polys[label] = row
    polys[("random", 0)] = (
        random_coeffs if isinstance(random_coeffs, np.ndarray) else random_poly
    )
    # folded h: h(X) = sum x^{n i} h_i(X)
    xn = pow(x, n, P)
    factors = []
    factor = 1
    for _ in range(n_h):
        factors.append(factor)
        factor = factor * xn % P
    h_rows = decoded[len(reg_list) - n_h :]
    if h_rows and isinstance(h_rows[0], np.ndarray):
        from .. import native

        polys[("h", 0)] = native.fold_scaled_fr(np.stack(h_rows), factors)
    else:
        h_np = np.zeros(n, dtype=object)
        for f_, row in zip(factors, h_rows):
            h_np = (h_np + f_ * np.array(row, dtype=object)) % P
        polys[("h", 0)] = [int(v) for v in h_np]

    from .queries import proof_queries

    queries, evals_order = proof_queries(st, x)

    evals = _eval_queries(polys, queries)
    for label, point in evals_order:
        transcript.write_scalar(evals[(label, point)])

    t = _phase("evaluations", t, eng)
    # --------------------------------------------------------------- multiopen
    def commit_host_coeffs(int_coeffs):
        return eng.commit_batch([eng.coeffs_from_values(int_coeffs)])[0]

    shplonk_open(params, transcript, polys, queries, evals, commit=commit_host_coeffs)
    t = _phase("multiopen", t, eng)

    return transcript.finalize()


def _eval_queries(polys, queries):
    """{(label, point): poly(point)} — native Horner when available, else
    vectorized object-array dots with shared power tables."""
    nat = _native_or_none()
    evals = {}
    if nat is not None:
        packed = {}
        by_label = {}
        for label, point in queries:
            by_label.setdefault(label, []).append(point)
        for label, pts in by_label.items():
            if label not in packed:
                p_ = polys[label]
                packed[label] = (
                    p_
                    if isinstance(p_, np.ndarray) and p_.dtype == np.uint64
                    else nat.pack_ints([int(v) for v in p_])
                )
            vals = nat.poly_eval_fr(packed[label], pts)
            for point, v in zip(pts, vals):
                evals[(label, point)] = v
        return evals
    pt_pows = {}
    n = max(len(polys[label]) for label, _ in queries)
    for _, point in queries:
        if point not in pt_pows:
            pws = np.empty(n, dtype=object)
            acc = 1
            for i in range(n):
                pws[i] = acc
                acc = acc * point % P
            pt_pows[point] = pws
    poly_np = {}
    for label, point in queries:
        if label not in poly_np:
            poly_np[label] = np.array(polys[label], dtype=object)
        prods = poly_np[label] * pt_pows[point][: len(poly_np[label])] % P
        evals[(label, point)] = int(prods.sum()) % P
    return evals


def _aux_query(idx, rot: int = 0):
    return Query(Column(ColumnKind.AUX, idx), Rotation(rot))


def _perm_labels(st):
    from .keygen import _delta

    delta = _delta()
    deltas = [pow(delta, i, P) for i in range(len(st.cs.permutation_columns))]
    omegas = [1] * st.n
    for j in range(1, st.n):
        omegas[j] = omegas[j - 1] * st.domain.omega % P
    return deltas, omegas


_AUX_STATIC_CACHE = {}


def _aux_extended(eng, st, beta, gamma, theta, y):
    """Static aux tensors on the extended coset + challenge broadcasts."""
    domain = st.domain
    key = (eng.name, str(getattr(eng, "device", None)), st.k, st.u, domain.extended_k)
    static = _AUX_STATIC_CACHE.get(key)
    ext_n = domain.extended_n
    if static is None:
        n = st.n
        ident = [
            domain.g_coset * pow(domain.extended_omega, i, P) % P for i in range(ext_n)
        ]
        l0_vals = [0] * n
        l0_vals[0] = 1
        l_last_vals = [0] * n
        l_last_vals[st.u] = 1
        l_blind_vals = [0] * n
        for r in range(st.u + 1, n):
            l_blind_vals[r] = 1
        static = {
            "identity": eng.epoly_from_values(ident),
            "l0": eng.coeff_to_extended(eng.to_coeffs(l0_vals)),
            "l_last": eng.coeff_to_extended(eng.to_coeffs(l_last_vals)),
            "l_blind": eng.coeff_to_extended(eng.to_coeffs(l_blind_vals)),
        }
        _AUX_STATIC_CACHE[key] = static

    aux = {
        st.aux.IDENTITY: static["identity"],
        st.aux.L0: static["l0"],
        st.aux.L_LAST: static["l_last"],
        st.aux.L_BLIND: static["l_blind"],
        st.aux.BETA: eng.epoly_const(beta),
        st.aux.GAMMA: eng.epoly_const(gamma),
        st.aux.THETA: eng.epoly_const(theta),
        st.aux.Y: eng.epoly_const(y),
    }
    return aux

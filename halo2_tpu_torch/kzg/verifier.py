"""KZG verifier (halo2 `verify_proof` with VerifierSHPLONK + SingleStrategy).

Host-side: replays the transcript, recomputes every challenge, evaluates the
shared quotient expression at x (instance evals by barycentric interpolation
from the public inputs — never committed, as in PSE halo2's KZG mode),
derives the expected h(x), and runs the SHPLONK pairing check.
"""

from __future__ import annotations

from ..field.params import BN254_FR
from .expr_eval import eval_expr
from .keygen import VerifyingKey, _horner
from .queries import proof_queries
from .shplonk import shplonk_verify
from .transcript import Blake2bRead

P = BN254_FR.p


def verify_proof(params, vk: VerifyingKey, proof: bytes, instances) -> bool:
    st = vk.structure
    cs, n, u = st.cs, st.n, st.u
    domain = st.domain
    transcript = Blake2bRead(proof)
    transcript.common_scalar(vk.digest)

    instance_padded = []
    for i in range(cs.num_instance):
        vals = [int(v) % P for v in (instances[i] if i < len(instances) else [])]
        instance_padded.append(vals + [0] * (n - len(vals)))
    for col in instance_padded:
        for v in col:
            transcript.common_scalar(v)

    advice_commitments = [transcript.read_point() for _ in range(cs.num_advice)]
    theta = int(transcript.squeeze_challenge())

    lookup_perm_commitments = []
    for _ in cs.lookups:
        ap = transcript.read_point()
        sp = transcript.read_point()
        lookup_perm_commitments.append((ap, sp))

    beta = int(transcript.squeeze_challenge())
    gamma = int(transcript.squeeze_challenge())

    perm_z_commitments = [transcript.read_point() for _ in st.perm_chunks]
    lookup_z_commitments = [transcript.read_point() for _ in cs.lookups]
    random_commitment = transcript.read_point()

    y = int(transcript.squeeze_challenge())

    num_h = domain.extended_n // n
    h_commitments = [transcript.read_point() for _ in range(num_h)]

    x = int(transcript.squeeze_challenge())

    queries, evals_order = proof_queries(st, x)
    evals = {}
    for label, point in evals_order:
        evals[(label, point)] = int(transcript.read_scalar())

    # ---------------------------------------------- expected h(x) from evals
    omega = domain.omega
    xn = pow(x, n, P)
    l0 = domain.l_i(0, x)
    l_last = domain.l_i(u, x)
    l_blind = 0
    for r in range(u + 1, n):
        l_blind = (l_blind + domain.l_i(r, x)) % P

    aux_env = {
        st.aux.IDENTITY: x,
        st.aux.L0: l0,
        st.aux.L_LAST: l_last,
        st.aux.L_BLIND: l_blind,
        st.aux.BETA: beta,
        st.aux.GAMMA: gamma,
        st.aux.THETA: theta,
        st.aux.Y: y,
    }
    num_fixed = cs.num_fixed

    def getq(kind, idx, rot):
        pt = x * pow(omega, rot % n, P) % P
        if kind == "advice":
            return evals[(("advice", idx), pt)]
        if kind == "fixed":
            return evals[(("fixed", idx), pt)]
        if kind == "selector":
            return evals[(("fixed", num_fixed + idx), pt)]
        if kind == "instance":
            return domain.eval_lagrange_interp(instance_padded[idx], pt)
        if kind == "aux":
            if idx in aux_env:
                return aux_env[idx]
            a = st.aux
            if a.PERM_Z_BASE <= idx < a.lookup_base:
                return evals[(("perm_z", idx - a.PERM_Z_BASE), pt)]
            if a.lookup_base <= idx < a.num_aux:
                li, which = divmod(idx - a.lookup_base, 3)
                lbl = [("lookup_ap", li), ("lookup_sp", li), ("lookup_z", li)][which]
                return evals[(lbl, pt)]
            return evals[(("sigma", idx - a.num_aux), pt)]
        raise KeyError((kind, idx, rot))

    from .prover import _aux_query

    combined = _horner(st.quotient_exprs, _aux_query(st.aux.Y))
    numerator = eval_expr(combined, getq)
    expected_h = numerator * pow((xn - 1) % P, -1, P) % P
    evals[(("h", 0), x)] = expected_h

    # ------------------------------------------------- commitment dictionary
    commitments = {}
    for i, c in enumerate(advice_commitments):
        commitments[("advice", i)] = c
    for i, c in enumerate(vk.fixed_commitments):
        commitments[("fixed", i)] = c
    for i, c in enumerate(vk.sigma_commitments):
        commitments[("sigma", i)] = c
    for i, c in enumerate(perm_z_commitments):
        commitments[("perm_z", i)] = c
    for i, (ap, sp) in enumerate(lookup_perm_commitments):
        commitments[("lookup_ap", i)] = ap
        commitments[("lookup_sp", i)] = sp
    for i, c in enumerate(lookup_z_commitments):
        commitments[("lookup_z", i)] = c
    commitments[("random", 0)] = random_commitment
    # fold h pieces: C_h = sum x^{n i} C_i
    from ..ec import host as ec

    factors = []
    factor = 1
    for _ in h_commitments:
        factors.append(factor)
        factor = factor * xn % P
    c_h = ec.g1_lincomb(h_commitments, factors)
    commitments[("h", 0)] = c_h

    ok = shplonk_verify(params, transcript, commitments, queries, evals)
    if ok:
        transcript.assert_consumed()
    return ok

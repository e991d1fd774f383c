"""Canonical opening-query and evaluation-write order, shared by prover+verifier."""

from __future__ import annotations

from ..field.params import BN254_FR

P = BN254_FR.p


def proof_queries(st, x: int):
    """Returns (queries, evals_order).

    queries: deduped list of (label, point) that enter the multiopen.
    evals_order: the exact sequence of (label, point) whose evals are written
    to / read from the transcript (h is computed, not written).
    """
    omega = st.domain.omega
    num_fixed = st.cs.num_fixed

    def rot_pt(rot: int) -> int:
        return x * pow(omega, rot % (st.n), P) % P

    evals_order = []
    for ci, rot in st.advice_queries:
        evals_order.append((("advice", ci), rot_pt(rot)))
    for ci, rot in st.fixed_queries:
        evals_order.append((("fixed", ci), rot_pt(rot)))
    for si, rot in st.selector_queries:
        evals_order.append((("fixed", num_fixed + si), rot_pt(rot)))
    evals_order.append((("random", 0), x))
    for gi in range(len(st.cs.permutation_columns)):
        evals_order.append((("sigma", gi), x))
    x_next = rot_pt(1)
    x_last = rot_pt(st.u)
    x_prev = rot_pt(-1)
    nchunks = len(st.perm_chunks)
    for c in range(nchunks):
        evals_order.append((("perm_z", c), x))
        evals_order.append((("perm_z", c), x_next))
    for c in range(nchunks - 1):
        evals_order.append((("perm_z", c), x_last))
    for i in range(len(st.cs.lookups)):
        evals_order.append((("lookup_z", i), x))
        evals_order.append((("lookup_z", i), x_next))
        evals_order.append((("lookup_ap", i), x))
        evals_order.append((("lookup_ap", i), x_prev))
        evals_order.append((("lookup_sp", i), x))

    queries = list(dict.fromkeys(evals_order))
    queries.append((("h", 0), x))
    return queries, evals_order

"""A Poseidon permutation in the sparse form of its partial rounds (Grassi
et al., *Poseidon*, USENIX Security 2021, Appendix B), in Python ints, that
counts its field products: the independent count that
``metrics/_counts.poseidon_products`` is held against.  The decomposition
follows the paper (the authors' ``calc_equivalent_constants`` and
``calc_equivalent_matrices``): constants folded backward from the last
partial round, and M = S_q B_q with B_q = diag(1, A_hat) passed on to the
round before."""

from __future__ import annotations


def _inv(a, p):
    n = len(a)
    m = [list(r) + [int(i == j) for j in range(n)] for i, r in enumerate(a)]
    for c in range(n):
        piv = next(r for r in range(c, n) if m[r][c] % p)
        m[c], m[piv] = m[piv], m[c]
        iv = pow(m[c][c], -1, p)
        m[c] = [v * iv % p for v in m[c]]
        for r in range(n):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(v - f * w) % p for v, w in zip(m[r], m[c])]
    return [r[n:] for r in m]


def _matmul(a, b, p):
    return [[sum(x * y for x, y in zip(r, c)) % p for c in zip(*b)] for r in a]


def _matvec(a, v, p):
    return [sum(x * y for x, y in zip(r, v)) % p for r in a]


def sparse_form(p, rcs, mds, r_f, r_p):
    w = len(mds)
    c = [list(rcs[r_f + q]) for q in range(r_p)]
    ks = [0] * r_p
    m_inv = _inv(mds, p)
    for q in range(r_p - 1, 0, -1):
        u = _matvec(m_inv, c[q], p)
        ks[q - 1] = u[0]
        c[q - 1] = [c[q - 1][0]] + [(c[q - 1][i] + u[i]) % p for i in range(1, w)]
    rows, cols = [None] * r_p, [None] * r_p
    a = [list(r) for r in mds]
    edge = None
    for q in range(r_p - 1, -1, -1):
        a_hat = [r[1:] for r in a[1:]]
        a_hat_inv = _inv(a_hat, p)
        rows[q] = [a[0][0]] + [sum(a[0][1 + i] * a_hat_inv[i][j] for i in range(w - 1)) % p for j in range(w - 1)]
        cols[q] = [a[i][0] for i in range(1, w)]
        b = [[1] + [0] * (w - 1)] + [[0] + r for r in a_hat]
        edge = b
        a = _matmul(b, mds, p)
    return c[0], ks, edge, rows, cols


class Counter:
    def __init__(self, p):
        self.p, self.products = p, 0

    def mul(self, a, b):
        self.products += 1
        return a * b % self.p

    def sbox(self, x):
        x2 = self.mul(x, x)
        return self.mul(self.mul(x2, x2), x)

    def matvec(self, m, v):
        return [sum(self.mul(x, y) for x, y in zip(r, v)) % self.p for r in m]


def permute_sparse(state, p, rcs, mds, r_f_total, r_p):
    """(output state, products counted) of one permutation."""
    r_f = r_f_total // 2
    w = len(state)
    cnt = Counter(p)
    c_hat, ks, edge, rows, cols = sparse_form(p, rcs, mds, r_f, r_p)
    x = list(state)

    def full(f):
        return cnt.matvec(mds, [cnt.sbox((v + rc) % p) for v, rc in zip(x, rcs[f])])

    for f in range(r_f):
        x = full(f)
    x = cnt.matvec(edge, [(v + c) % p for v, c in zip(x, c_hat)])
    for q in range(r_p):
        x0 = (cnt.sbox(x[0]) + ks[q]) % p
        new0 = (cnt.mul(rows[q][0], x0) + sum(cnt.mul(r, v) for r, v in zip(rows[q][1:], x[1:]))) % p
        x = [new0] + [(v + cnt.mul(c, x0)) % p for v, c in zip(x[1:], cols[q])]
    for f in range(r_f + r_p, 2 * r_f + r_p):
        x = full(f)
    assert len(x) == w
    return x, cnt.products

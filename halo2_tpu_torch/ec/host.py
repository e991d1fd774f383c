"""Host-side BN254 (alt_bn128) curve + optimal-ate pairing (Python ints).

Replaces the verifier-side slice of `halo2curves::bn256` consumed by the
reference's KZG path (src/circuits/utils.rs:40-63): G1/G2 arithmetic and the
pairing product check.  The pairing is the standard py_ecc-style construction:
FQ2 = Fq[i]/(i^2+1), FQ12 = Fq[w]/(w^12 - 18 w^6 + 82), twist into FQ12,
Miller loop with ate_loop_count 29793968203157093288, naive final
exponentiation.  A few pairings per verification run host-side in ~1s —
sequential, tiny, and off the TPU hot path by design.
"""

from __future__ import annotations

from ..field.params import BN254_FQ, BN254_FR

P = BN254_FQ.p
R = BN254_FR.p

ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63


class FQP:
    """Polynomial extension field element over Fq."""

    degree = 0
    modulus_coeffs: tuple = ()

    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.c = [x % P for x in coeffs]

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    def __add__(self, o):
        return type(self)([a + b for a, b in zip(self.c, o.c)])

    def __sub__(self, o):
        return type(self)([a - b for a, b in zip(self.c, o.c)])

    def __neg__(self):
        return type(self)([-a for a in self.c])

    def __mul__(self, o):
        d = self.degree
        if isinstance(o, int):
            return type(self)([a * o for a in self.c])
        b = [0] * (2 * d - 1)
        for i, x in enumerate(self.c):
            if x:
                for j, y in enumerate(o.c):
                    b[i + j] += x * y
        for exp in range(2 * d - 2, d - 1, -1):
            top = b[exp] % P
            if top:
                for i, mc in enumerate(self.modulus_coeffs):
                    b[exp - d + i] -= top * mc
            b[exp] = 0
        return type(self)(b[:d])

    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fq[x] mod the modulus polynomial."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = self.c + [0]
        high = list(self.modulus_coeffs) + [1]

        def deg(p):
            for i in reversed(range(len(p))):
                if p[i] % P:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            for i in range(dega - degb, -1, -1):
                q = temp[degb + i] * pow(b[degb], -1, P)
                o[i] += q
                for c in range(degb + 1):
                    temp[c + i] -= o[i] * b[c]
            return [x % P for x in o[: deg(o) + 1]]

        while deg(low):
            rq = poly_rounded_div(high, low)
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    if i < len(rq):
                        nm[i + j] -= lm[j] * rq[i]
                        new[i + j] -= low[j] * rq[i]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_low0 = pow(low[0], -1, P)
        return type(self)([(x * inv_low0) % P for x in lm[:d]])

    def __truediv__(self, o):
        return self * o.inv()

    def __eq__(self, o):
        return type(o) is type(self) and self.c == o.c

    def is_zero(self):
        return all(x == 0 for x in self.c)

    def __repr__(self):
        return f"{type(self).__name__}({self.c})"


class FQ1(FQP):
    degree = 1
    modulus_coeffs = (0,)  # unused

    def inv(self):
        return FQ1([pow(self.c[0], -1, P)])


class FQ2(FQP):
    degree = 2
    modulus_coeffs = (1, 0)  # i^2 = -1


class FQ12(FQP):
    degree = 12
    modulus_coeffs = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 = 18w^6 - 82


# -- generic short-Weierstrass (y^2 = x^3 + b) point ops with None = infinity
def ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return ec_double(p1)
        return None
    m = (y2 - y1) / (x2 - x1)
    x3 = m * m - x1 - x2
    return (x3, m * (x1 - x3) - y1)


def ec_double(pt):
    if pt is None:
        return None
    x, y = pt
    if y.is_zero():
        return None
    m = (x * x * 3) / (y * 2)
    x3 = m * m - x - x
    return (x3, m * (x - x3) - y)


def ec_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def ec_mul(pt, s: int):
    s %= R
    result = None
    addend = pt
    while s:
        if s & 1:
            result = ec_add(result, addend)
        addend = ec_double(addend)
        s >>= 1
    return result


# -- canonical generators
G1 = (FQ1([1]), FQ1([2]))
G2 = (
    FQ2([
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ]),
    FQ2([
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ]),
)


def g1_from_ints(x: int, y: int):
    """(x, y) ints -> host G1 point; (0, 0) means infinity."""
    if x == 0 and y == 0:
        return None
    return (FQ1([x]), FQ1([y]))


def g1_to_ints(pt):
    if pt is None:
        return (0, 0)
    return (pt[0].c[0], pt[1].c[0])


def is_on_curve_g1(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x) == FQ1([3])


# -- pairing ---------------------------------------------------------------
_W2 = FQ12([0, 0, 1] + [0] * 9)
_W3 = FQ12([0, 0, 0, 1] + [0] * 8)


def twist(pt):
    """E'(FQ2) -> E(FQ12)."""
    if pt is None:
        return None
    x, y = pt
    xc = [x.c[0] - 9 * x.c[1], x.c[1]]
    yc = [y.c[0] - 9 * y.c[1], y.c[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * _W2, ny * _W3)


def cast_g1_to_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x.c[0]] + [0] * 11), FQ12([y.c[0]] + [0] * 11))


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 - x2).is_zero():
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def miller_loop(q, p):
    """q: twisted G2 point in FQ12, p: G1 point in FQ12. No final exp."""
    if q is None or p is None:
        return FQ12.one()
    r_pt = q
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r_pt, r_pt, p)
        r_pt = ec_double(r_pt)
        if ATE_LOOP_COUNT & (2 ** i):
            f = f * _linefunc(r_pt, q, p)
            r_pt = ec_add(r_pt, q)
    q1 = (q[0] ** P, q[1] ** P)
    nq2 = (q1[0] ** P, -(q1[1] ** P))
    f = f * _linefunc(r_pt, q1, p)
    r_pt = ec_add(r_pt, q1)
    f = f * _linefunc(r_pt, nq2, p)
    return f


def final_exponentiate(f):
    return f ** ((P ** 12 - 1) // R)


def pairing(q_g2, p_g1):
    """e(P, Q) with P in G1, Q in G2."""
    return final_exponentiate(miller_loop(twist(q_g2), cast_g1_to_fq12(p_g1)))


def pairing_product_is_one(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 with a single final exponentiation.

    pairs: list of (G1 point, G2 point).  Dispatches to the native C++
    optimal-ate pairing (halo2_tpu/native) when available — the Python
    fallback's naive final exponentiation costs ~2 s per verify, the native
    check ~30 ms (round-5 VERDICT item 3); both constructions are
    cross-checked coefficientwise in tests/test_native.py.
    """
    from .. import native

    if native.available():
        flat = []
        for p_g1, q_g2 in pairs:
            px, py = g1_to_ints(p_g1)
            if q_g2 is None:
                qx = qy = (0, 0)
            else:
                qx = (q_g2[0].c[0], q_g2[0].c[1])
                qy = (q_g2[1].c[0], q_g2[1].c[1])
            flat.append(((px, py), (qx, qy)))
        return native.pairing_product_is_one(flat)
    f = FQ12.one()
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        f = f * miller_loop(twist(q_g2), cast_g1_to_fq12(p_g1))
    return final_exponentiate(f) == FQ12.one()


def g1_lincomb(points, scalars):
    """sum_i s_i * P_i over host G1 points — the verifier's commitment folds
    (halo2 runs these through halo2curves' native MSM; the FQP affine ladder
    costs one modular inversion per group op).  Native C++ Pippenger when
    available, else the int-Jacobian host Pippenger below."""
    from .. import native

    points = list(points)
    scalars = [int(s) % R for s in scalars]
    if native.available():
        xs, ys = [], []
        for p in points:
            x, y = g1_to_ints(p)
            xs.append(x)
            ys.append(y)
        px = native.to_mont(native.pack_ints(xs), "fq")
        py = native.to_mont(native.pack_ints(ys), "fq")
        x, y = native.msm_g1_mont(px, py, native.pack_ints(scalars))
        return g1_from_ints(x, y)
    return msm_host(points, scalars)


# -- fast host G1 ops on plain int Jacobian tuples (no FQP overhead) --------
def _jadd(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 % P * z2z2 % P
    s2 = y2 * z1 % P * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jdouble(p1)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = 2 * z1 * z2 % P * h % P
    return (x3, y3, z3)


def _jdouble(p1):
    if p1 is None:
        return None
    x, y, z = p1
    if y == 0:
        return None
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _jac_to_host_point(p):
    if p is None or p[2] == 0:
        return None
    zinv = pow(p[2], -1, P)
    zinv2 = zinv * zinv % P
    return g1_from_ints(p[0] * zinv2 % P, p[1] * zinv2 % P * zinv % P)


def msm_host(points, scalars):
    """Host Pippenger over int Jacobian tuples — the CPU-backend fallback
    used by tests; the device Pippenger is the TPU path."""
    jpts = []
    svals = []
    for pt, s in zip(points, scalars):
        s %= R
        if pt is None or s == 0:
            continue
        jpts.append((int(pt[0].c[0]), int(pt[1].c[0]), 1))
        svals.append(s)
    if not jpts:
        return None
    c = 8
    acc = None
    for w in range(255 // c, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = _jdouble(acc)
        buckets = {}
        shift = c * w
        for pt, s in zip(jpts, svals):
            digit = (s >> shift) & ((1 << c) - 1)
            if digit:
                buckets[digit] = _jadd(buckets.get(digit), pt)
        # sum_{d} d*B_d via descending running sums (suffix-sum identity)
        running = None
        wsum = None
        prev = None
        for digit in sorted(buckets, reverse=True):
            if prev is not None:
                for _ in range(prev - digit):
                    wsum = _jadd(wsum, running)
            running = _jadd(running, buckets[digit])
            prev = digit
        if prev is not None:
            for _ in range(prev):
                wsum = _jadd(wsum, running)
        acc = _jadd(acc, wsum)
    return _jac_to_host_point(acc)

"""The roofline counts (``metrics/_counts.py``) against independent counts
at small sizes, and the benchmark's own arithmetic against Python ints."""

import math
import random

import pytest
import torch

from benchmark import fields
from benchmark.metrics import _counts
from benchmark.reference import _evaluate, _poseidon
from sparse_poseidon import permute_sparse


@pytest.mark.parametrize("width", [3, 5])
def test_poseidon_products_match_a_counted_sparse_permutation(width):
    p = fields.FR
    rcs, mds = _poseidon.constants(p, width, 8, 56)
    rng = random.Random(width)
    state = [rng.randrange(p) for _ in range(width)]
    out, products = permute_sparse(state, p, rcs, mds, 8, 56)
    assert out == _poseidon.permute(state, p, 8, 56)
    assert products == _counts.poseidon_products(width, 8, 56)


def test_ntt_stage_products_match_a_counted_inverse_transform():
    p, k = fields.FR, 4
    n = 1 << k
    omega_inv = pow(pow(7, (p - 1) >> k, p), -1, p)
    rng = random.Random(1)
    v = [rng.randrange(p) for _ in range(n)]
    x = [v[int(f"{i:0{k}b}"[::-1], 2)] for i in range(n)]
    products, m = 0, 1
    while m < n:
        w_m = pow(omega_inv, n // (2 * m), p)
        for s in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                t = w * x[s + j + m] % p
                products += 1
                x[s + j], x[s + j + m] = (x[s + j] + t) % p, (x[s + j] - t) % p
                w = w * w_m % p
        m *= 2
    assert [c * pow(n, -1, p) % p for c in x] == [
        sum(v[j] * pow(omega_inv, i * j, p) for j in range(n)) * pow(n, -1, p) % p for i in range(n)
    ]
    assert products == _counts.ntt_stage_products(n) == n // 2 * k


def test_product_cost_is_a_counted_cios_product():
    """Montgomery's CIOS over eight 32-bit words, counting issue slots: a
    32 x 32 -> 64-bit product takes two (low, high), one whose low half is
    known to cancel takes one, a low-half-only product one."""
    p, mask = fields.FR, (1 << 32) - 1
    n0 = (-pow(p, -1, 1 << 32)) & mask
    pw = [(p >> (32 * i)) & mask for i in range(8)]
    rng = random.Random(2)
    a, b = rng.randrange(p), rng.randrange(p)
    aw, bw = [(a >> (32 * i)) & mask for i in range(8)], [(b >> (32 * i)) & mask for i in range(8)]
    slots, t = 0, [0] * 10
    for i in range(8):
        carry = 0
        for j in range(8):
            v = t[j] + aw[i] * bw[j] + carry
            slots += 2
            t[j], carry = v & mask, v >> 32
        v = t[8] + carry
        t[8], t[9] = v & mask, v >> 32
        m = (t[0] * n0) & mask
        slots += 1
        v = t[0] + m * pw[0]
        slots += 1  # the high half only: the low half is 0
        carry = v >> 32
        for j in range(1, 8):
            v = t[j] + m * pw[j] + carry
            slots += 2
            t[j - 1], carry = v & mask, v >> 32
        v = t[8] + carry
        t[7], t[8] = v & mask, t[9] + (v >> 32)
    r = sum(w << (32 * i) for i, w in enumerate(t[:9]))
    r = r - p if r >= p else r
    assert r == a * b * pow(1 << 256, -1, p) % p
    assert slots == _counts.IMAD_PER_PRODUCT == 256


def test_peaks():
    assert _counts.IMAD_PER_S == 132 * 64 * 1.98e9
    assert math.isclose(_counts.poseidon_hash_bound_s(1 << 20, 4, 5, 4, 8, 56), (1 << 20) * 1017 * 256 / _counts.IMAD_PER_S)


def test_plain_montgomery_product():
    p = fields.FR
    rng = random.Random(97)
    a = [rng.randrange(p) for _ in range(300)] + [0, p - 1]
    b = [rng.randrange(p) for _ in range(301)] + [p - 1]
    got = fields.limbs_to_ints(
        fields.mont_mul(torch.from_numpy(fields.ints_to_limbs(a)), torch.from_numpy(fields.ints_to_limbs(b)), p)
    )
    assert got == [x * y * pow(fields.R, -1, p) % p for x, y in zip(a, b)]


def test_noncanonical_count():
    p = fields.FR
    x = torch.from_numpy(fields.ints_to_limbs([0, p - 1, p, p + 5, (1 << 256) - 1]))
    assert fields.count_noncanonical(x, p) == 3
    x[3, 1] = 1 << 16
    assert fields.count_noncanonical(x, p) == 4


def test_exact_evaluation():
    p, n = fields.FR, 1 << 10
    rng = random.Random(3)
    cols = [[rng.randrange(1 << 256) for _ in range(n)] for _ in range(3)]
    limbs = torch.stack([torch.from_numpy(fields.ints_to_limbs(c)) for c in cols])
    x = rng.randrange(p)
    got = _evaluate.evaluate(limbs, _evaluate.power_limbs(x, n, p, "cpu"), p)
    assert got == [sum(c * pow(x, i, p) for i, c in enumerate(col)) % p for col in cols]


def test_trace_busy_union_and_gaps():
    from benchmark.trace import summarize_events

    dev = [("k1", 10, 20), ("k2", 15, 30), ("copy", 40, 50)]
    host = [("bench.request", 0, 100), ("bench.wait", 30, 45), ("cudaDeviceSynchronize", 31, 39)]
    s = summarize_events(0, 100, dev, host)
    assert s["busy_s"] == 30 / 1e9 and s["window_s"] == 100 / 1e9
    assert dict((n, round(v * 1e9)) for n, v in s["idle_gaps"]) == {
        "bench.request": 10 + 50,
        "cudaDeviceSynchronize": 10,
    }
    assert s["device_ops"][0] == ["k2", 15 / 1e9]

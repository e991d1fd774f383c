"""Witness-side helpers (reference src/chips/utils.rs).

Semantics preserved, implementation idiomatic: the reference's O(value/2^N)
repeated-subtraction limb split (utils.rs:38-47) and Debug-hex-string
field->BigUint conversion (utils.rs:66-71) are replaced by equivalent
canonical-integer divmod / direct int access — bit-identical results for all
field values, documented divergence per SURVEY.md §7.
"""

from __future__ import annotations

from ..plonkish.expression import Constant, Expression
from ..plonkish.value import Value


def value_f_to_big_uint(v: Value) -> int:
    """Value<F> -> canonical integer (0 when unknown) — utils.rs:26-30."""
    inner = v.value()
    return int(inner) if inner is not None else 0


def f_to_big_uint(value) -> int:
    """F -> canonical integer — utils.rs:32-36."""
    return int(value)


def f_to_nbits(n_bits: int, value):
    """Split canonical(value) into (value >> n_bits, value & mask) as field
    elements — equivalent to the reference's repeated subtraction loop
    (utils.rs:38-47) for every field value, since halo2curves `Ord` compares
    canonical integers."""
    F = type(value)
    hi, lo = divmod(int(value), 1 << n_bits)
    return F(hi), F(lo)


def add_carry(max_bits: int, value: Value, hi, lo):
    """sum = value + hi * 2^max_bits + lo, re-split into (hi, lo) limbs —
    utils.rs:49-64."""
    F = _field_of(value, hi, lo)
    total = F(0)
    inner = value.value()
    if inner is not None:
        total = total + inner
    hv = hi.value().value()
    if hv is not None:
        total = total + hv * F(1 << max_bits)
    lv = lo.value().value()
    if lv is not None:
        total = total + lv
    return f_to_nbits(max_bits, total)


def _field_of(value: Value, *cells):
    inner = value.value()
    if inner is not None:
        return type(inner)
    for c in cells:
        v = c.value().value()
        if v is not None:
            return type(v)
    raise ValueError("cannot infer field from unknown values")


def range_check(value: Expression, range_: int) -> Expression:
    """Polynomial range check: value * (1 - value) * (2 - value) * ... —
    utils.rs:73-77."""
    acc = value
    for i in range(1, range_):
        acc = acc * (Constant(i) - value)
    return acc


def range_check_vec(selector: Expression, value_vec, range_: int):
    """Apply range_check to each expression, gated by selector — utils.rs:79-89."""
    return [selector * range_check(w, range_) for w in value_vec]


def decompose_bigint_to_ubits(e: int, number_of_limbs: int, bit_len: int, F):
    """Little-endian bit_len-bit limbs of e as field elements — utils.rs:92-127."""
    assert bit_len <= 64
    mask = (1 << bit_len) - 1
    return [F((e >> (bit_len * i)) & mask) for i in range(number_of_limbs)]

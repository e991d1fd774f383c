"""IsZeroChip — classic is_zero gadget (reference src/chips/is_zero.rs).

Gate ``q * value * (1 - value * value_inv)`` exposing ``is_zero_expr``
(is_zero.rs:34-49), with the documented truth table:

    valid | value |  value_inv |  1 - value*value_inv | value*(1 - value*value_inv)
    ------+-------+------------+----------------------+----------------------------
     yes  |   x   |    1/x     |         0            |  0
     no   |   x   |    0       |         1            |  x
     yes  |   0   |    0       |         1            |  0
     yes  |   0   |    y       |         1            |  0
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation
from ..plonkish.expression import Constant, Expression


@dataclasses.dataclass
class IsZeroConfig:
    value_inv: object
    is_zero_expr: Expression

    def expr(self) -> Expression:
        return self.is_zero_expr


class IsZeroChip:
    def __init__(self, config: IsZeroConfig):
        self.config = config

    construct = classmethod(lambda cls, config: cls(config))

    @staticmethod
    def configure(meta, q_enable, value, value_inv) -> IsZeroConfig:
        """q_enable/value: callables VirtualCells -> Expression (as in the
        reference's closure-based configure, is_zero.rs:26-55)."""
        holder = {}

        def gate(m):
            v = value(m)
            q = q_enable(m)
            v_inv = m.query_advice(value_inv, Rotation.cur())
            holder["expr"] = Constant(1) - v * v_inv
            return [q * v * holder["expr"]]

        meta.create_gate("is_zero", gate)
        return IsZeroConfig(value_inv, holder["expr"])

    def assign(self, region, offset: int, value):
        value_inv = value.map(lambda v: v.invert_or_zero())
        region.assign_advice("value inv", self.config.value_inv, offset, value_inv)

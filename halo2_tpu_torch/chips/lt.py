"""LtChip — lhs < rhs via byte decomposition (zkevm-circuits `gadgets::less_than`).

Re-design of the gadget consumed by the reference at
src/circuits/less_than_v2.rs:2, less_than_v3.rs:3 and
src/chips/merkle_sum_tree.rs:4 (behavior documented in reference
README.md:277-297): ``lt`` advice + ``diff[N_BYTES]`` advice + a u8 fixed
table; gate ``q * (lhs - rhs - diff + lt*range)`` with ``range = 2^(8*N_BYTES)``
and ``q * bool_check(lt)``; each diff byte is range-looked-up into the u8
table; ``is_lt(meta, None)`` exposes the lt expression.
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from .util import bool_check, expr_from_bytes, pow_of_two


@dataclasses.dataclass
class LtConfig:
    n_bytes: int
    lt: object            # advice: 1 when lhs < rhs
    diff: list            # advice byte columns
    range: int            # 2^(8*n_bytes), canonical constant
    u8: object            # fixed u8 table column

    def is_lt(self, meta, rotation: Rotation = None):
        return meta.query_advice(self.lt, rotation or Rotation.cur())


class LtChip:
    def __init__(self, config: LtConfig, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, q_enable, lhs, rhs, n_bytes: int = 8) -> LtConfig:
        """q_enable/lhs/rhs: callables VirtualCells -> Expression."""
        lt = meta.advice_column()
        diff = [meta.advice_column() for _ in range(n_bytes)]
        range_ = pow_of_two(n_bytes * 8)
        u8 = meta.fixed_column()

        config = LtConfig(n_bytes, lt, diff, range_, u8)

        def gate(m):
            q = q_enable(m)
            lt_e = m.query_advice(lt, Rotation.cur())
            diff_bytes = [m.query_advice(c, Rotation.cur()) for c in diff]
            check_a = lhs(m) - rhs(m) - expr_from_bytes(diff_bytes) + lt_e * range_
            check_b = bool_check(lt_e)
            return [q * check_a, q * check_b]

        meta.create_gate("lt gate", gate)

        meta.annotate_lookup_any_column(u8, lambda: "LOOKUP_u8")
        for column in diff:
            def lookup(m, column=column):
                u8_cell = m.query_advice(column, Rotation.cur())
                u8_range = m.query_fixed(u8, Rotation.cur())
                return [(u8_cell, u8_range)]

            meta.lookup_any("range check for u8", lookup)

        return config

    # LtInstruction
    def assign(self, region, offset: int, lhs, rhs):
        cfg = self.config
        F = self.F
        lt = int(lhs) < int(rhs)
        region.assign_advice(
            "lt chip: lt", cfg.lt, offset, Value.known(F.from_u64(1 if lt else 0))
        )
        diff = (lhs - rhs) + (F.from_u64(0) + cfg.range if lt else F.zero())
        diff_bytes = diff.to_repr()  # 32 little-endian bytes
        for idx, diff_col in enumerate(cfg.diff):
            region.assign_advice(
                f"lt chip: diff byte {idx}",
                diff_col,
                offset,
                Value.known(F.from_u64(diff_bytes[idx])),
            )

    def load(self, layouter):
        def closure(region):
            for i in range(256):
                region.assign_fixed(
                    "u8 table", self.config.u8, i, Value.known(self.F.from_u64(i))
                )

        return layouter.assign_region("load u8 range check table", closure)

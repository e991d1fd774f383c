"""Pow5Chip — in-circuit Poseidon permutation (halo2_gadgets `poseidon::Pow5Chip`).

Layout re-created from the gadget the reference consumes
(src/chips/poseidon/hash.rs:9): WIDTH state advice columns, one partial_sbox
advice column, rc_a/rc_b fixed columns (WIDTH each), three gates:

* full round:    for each i: sum_j pow5(state_j + rc_a_j) * M[i][j] == state_i@next
* partial rounds (two per row): pow5(state_0 + rc_a_0) == partial_sbox;
  pow5(mid_0 + rc_b_0) == sum_j state_j@next * M^-1[0][j];
  and for i>0: mid_i + rc_b_i == sum_j state_j@next * M^-1[i][j],
  where mid_i = partial_sbox*M[i][0] + sum_{j>0}(state_j + rc_a_j)*M[i][j]
* pad-and-add:   initial_state@prev + input@cur == output@next (rate words),
  capacity word copied through.

plus the duplex-sponge Hash gadget (initial_state from constants, absorb via
pad-and-add regions, permute regions of 1 + R_F/2 + R_P/2 + R_F/2 rows).
Requires even R_F and R_P, RATE == WIDTH-1.
"""

from __future__ import annotations

import dataclasses

from ...plonkish import Rotation, Value
from ...plonkish.expression import Constant
from ...poseidon.primitives import ConstantLength, Spec


def _pow5(v):
    v2 = v * v
    return v2 * v2 * v


@dataclasses.dataclass
class Pow5Config:
    state: list
    partial_sbox: object
    rc_a: list
    rc_b: list
    s_full: object
    s_partial: object
    s_pad_and_add: object
    half_full_rounds: int
    half_partial_rounds: int
    round_constants: list  # host field elements [(R, WIDTH)]
    m_reg: list
    m_inv: list
    spec: Spec


class Pow5Chip:
    def __init__(self, config: Pow5Config, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, spec: Spec, F, state, partial_sbox, rc_a, rc_b) -> Pow5Config:
        width, rate = spec.width, spec.rate
        assert rate == width - 1
        assert spec.full_rounds() % 2 == 0 and spec.partial_rounds() % 2 == 0
        half_full_rounds = spec.full_rounds() // 2
        half_partial_rounds = spec.partial_rounds() // 2
        round_constants, m_reg, m_inv = spec.constants(F)

        for column in list(state) + list(rc_b):
            meta.enable_equality(column)

        s_full = meta.selector()
        s_partial = meta.selector()
        s_pad_and_add = meta.selector()

        def full_round_gate(m):
            s = m.query_selector(s_full)
            constraints = []
            for next_idx in range(width):
                state_next = m.query_advice(state[next_idx], Rotation.next())
                expr = None
                for idx in range(width):
                    cur = m.query_advice(state[idx], Rotation.cur())
                    rc = m.query_fixed(rc_a[idx], Rotation.cur())
                    term = _pow5(cur + rc) * Constant(int(m_reg[next_idx][idx]))
                    expr = term if expr is None else expr + term
                constraints.append(s * (expr - state_next))
            return constraints

        meta.create_gate("full round", full_round_gate)

        def partial_rounds_gate(m):
            cur_0 = m.query_advice(state[0], Rotation.cur())
            mid_0 = m.query_advice(partial_sbox, Rotation.cur())
            rc_a0 = m.query_fixed(rc_a[0], Rotation.cur())
            rc_b0 = m.query_fixed(rc_b[0], Rotation.cur())
            s = m.query_selector(s_partial)

            def mid(idx):
                acc = mid_0 * Constant(int(m_reg[idx][0]))
                for cur_idx in range(1, width):
                    cur = m.query_advice(state[cur_idx], Rotation.cur())
                    rc = m.query_fixed(rc_a[cur_idx], Rotation.cur())
                    acc = acc + (cur + rc) * Constant(int(m_reg[idx][cur_idx]))
                return acc

            def nxt(idx):
                acc = None
                for next_idx in range(width):
                    n = m.query_advice(state[next_idx], Rotation.next())
                    term = n * Constant(int(m_inv[idx][next_idx]))
                    acc = term if acc is None else acc + term
                return acc

            constraints = [
                s * (_pow5(cur_0 + rc_a0) - mid_0),
                s * (_pow5(mid(0) + rc_b0) - nxt(0)),
            ]
            for idx in range(1, width):
                rc_b_i = m.query_fixed(rc_b[idx], Rotation.cur())
                constraints.append(s * (mid(idx) + rc_b_i - nxt(idx)))
            return constraints

        meta.create_gate("partial rounds", partial_rounds_gate)

        def pad_and_add_gate(m):
            s = m.query_selector(s_pad_and_add)
            constraints = []
            for idx in range(rate):
                initial = m.query_advice(state[idx], Rotation.prev())
                inp = m.query_advice(state[idx], Rotation.cur())
                output = m.query_advice(state[idx], Rotation.next())
                constraints.append(s * (initial + inp - output))
            initial_rate = m.query_advice(state[rate], Rotation.prev())
            output_rate = m.query_advice(state[rate], Rotation.next())
            constraints.append(s * (initial_rate - output_rate))
            return constraints

        meta.create_gate("pad-and-add", pad_and_add_gate)

        return Pow5Config(
            list(state),
            partial_sbox,
            list(rc_a),
            list(rc_b),
            s_full,
            s_partial,
            s_pad_and_add,
            half_full_rounds,
            half_partial_rounds,
            round_constants,
            m_reg,
            m_inv,
            spec,
        )

    # ------------------------------------------------------------ instructions
    def initial_state(self, layouter, domain: ConstantLength):
        """Rate words zeroed, capacity = domain element — from constants."""
        cfg, F = self.config, self.F

        def closure(region):
            state = []
            for i in range(cfg.spec.rate):
                state.append(
                    region.assign_advice_from_constant(f"state_{i}", cfg.state[i], 0, F.zero())
                )
            state.append(
                region.assign_advice_from_constant(
                    f"state_{cfg.spec.rate}",
                    cfg.state[cfg.spec.rate],
                    0,
                    domain.initial_capacity_element(F),
                )
            )
            return state

        return layouter.assign_region("initial state for domain ConstantLength", closure)

    def add_input(self, layouter, initial_state, input_words):
        """input_words: list of ('msg', AssignedCell) | ('pad', F value)."""
        cfg, F = self.config, self.F
        rate = cfg.spec.rate

        def closure(region):
            cfg.s_pad_and_add.enable(region, 1)
            loaded = [
                initial_state[i].copy_advice(f"load state_{i}", region, cfg.state[i], 0)
                for i in range(cfg.spec.width)
            ]
            inputs = []
            for i in range(rate):
                tag, w = input_words[i]
                if tag == "pad":
                    # padding goes through a fixed cell (rc_b scratch) and is
                    # copy-constrained into the state column
                    fixed_cell = region.assign_fixed(
                        f"load pad_{i}", cfg.rc_b[i], 1, Value.known(w)
                    )
                    cell = region.assign_advice(
                        f"load input_{i}", cfg.state[i], 1, Value.known(w)
                    )
                    region.constrain_equal(fixed_cell.cell(), cell.cell())
                    inputs.append(cell)
                else:
                    inputs.append(w.copy_advice(f"load input_{i}", region, cfg.state[i], 1))
            output = []
            for i in range(rate):
                val = loaded[i].value() + inputs[i].value()
                output.append(region.assign_advice(f"load output_{i}", cfg.state[i], 2, val))
            output.append(
                region.assign_advice(
                    f"load output_{rate}", cfg.state[rate], 2, loaded[rate].value()
                )
            )
            return output

        return layouter.assign_region("add input for domain ConstantLength", closure)

    def permute(self, layouter, initial_state):
        cfg, F = self.config, self.F
        width = cfg.spec.width
        rcs, m = cfg.round_constants, cfg.m_reg

        def closure(region):
            # row 0: load initial state
            state = [
                initial_state[i].copy_advice(f"load state_{i}", region, cfg.state[i], 0)
                for i in range(width)
            ]

            def get_vals(cells):
                vals = [c.value().value() for c in cells]
                return None if any(v is None for v in vals) else vals

            def assign_next(next_vals, offset):
                return [
                    region.assign_advice(
                        f"state_{i}",
                        cfg.state[i],
                        offset + 1,
                        Value.known(next_vals[i]) if next_vals else Value.unknown(),
                    )
                    for i in range(width)
                ]

            def load_rc(cols, round_idx, offset):
                for idx, col in enumerate(cols):
                    region.assign_fixed(
                        f"round_{round_idx} rc_{idx}", col, offset, Value.known(rcs[round_idx][idx])
                    )

            def full_round(state, round_idx, offset):
                cfg.s_full.enable(region, offset)
                load_rc(cfg.rc_a, round_idx, offset)
                vals = get_vals(state)
                nxt = None
                if vals is not None:
                    r = [_hpow5(v + rcs[round_idx][i]) for i, v in enumerate(vals)]
                    nxt = [
                        sum((m[i][j] * r[j] for j in range(width)), start=F.zero())
                        for i in range(width)
                    ]
                return assign_next(nxt, offset)

            def partial_round(state, round_idx, offset):
                cfg.s_partial.enable(region, offset)
                load_rc(cfg.rc_a, round_idx, offset)
                load_rc(cfg.rc_b, round_idx + 1, offset)
                vals = get_vals(state)
                nxt = None
                if vals is not None:
                    r = [_hpow5(vals[0] + rcs[round_idx][0])] + [
                        vals[i] + rcs[round_idx][i] for i in range(1, width)
                    ]
                    region.assign_advice(
                        f"round_{round_idx} partial_sbox",
                        cfg.partial_sbox,
                        offset,
                        Value.known(r[0]),
                    )
                    p_mid = [
                        sum((m[i][j] * r[j] for j in range(width)), start=F.zero())
                        for i in range(width)
                    ]
                    r_mid = [_hpow5(p_mid[0] + rcs[round_idx + 1][0])] + [
                        p_mid[i] + rcs[round_idx + 1][i] for i in range(1, width)
                    ]
                    nxt = [
                        sum((m[i][j] * r_mid[j] for j in range(width)), start=F.zero())
                        for i in range(width)
                    ]
                else:
                    region.assign_advice(
                        f"round_{round_idx} partial_sbox",
                        cfg.partial_sbox,
                        offset,
                        Value.unknown(),
                    )
                return assign_next(nxt, offset)

            hf, hp = cfg.half_full_rounds, cfg.half_partial_rounds
            for r in range(hf):
                state = full_round(state, r, r)
            for r in range(hp):
                state = partial_round(state, hf + 2 * r, hf + r)
            for r in range(hf):
                state = full_round(state, hf + 2 * hp + r, hf + hp + r)
            return state

        return layouter.assign_region("permute state", closure)


def _hpow5(v):
    v2 = v * v
    return v2 * v2 * v


class HashGadget:
    """In-circuit ConstantLength hash (halo2_gadgets `poseidon::Hash`)."""

    def __init__(self, chip: Pow5Chip, domain: ConstantLength, state):
        self.chip = chip
        self.domain = domain
        self.state = state

    @classmethod
    def init(cls, chip: Pow5Chip, layouter, domain: ConstantLength) -> "HashGadget":
        state = chip.initial_state(layouter, domain)
        return cls(chip, domain, state)

    def hash(self, layouter, message_cells):
        chip = self.chip
        rate = chip.config.spec.rate
        words = [("msg", c) for c in message_cells] + [
            ("pad", p) for p in self.domain.padding(chip.F, rate)
        ]
        assert len(words) % rate == 0
        state = self.state
        for chunk_start in range(0, len(words), rate):
            chunk = words[chunk_start : chunk_start + rate]
            state = chip.add_input(
                layouter.namespace("PoseidonSponge add_input"), state, chunk
            )
            state = chip.permute(layouter.namespace("PoseidonSponge permute"), state)
        return state[0]

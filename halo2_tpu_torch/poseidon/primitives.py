"""Poseidon primitive: specs, the host sponge, and a batched device sponge.

The specs and the host sponge are halo2_tpu/poseidon/primitives.py lines
24-144, carried over unchanged because that file also holds the JAX device
sponge and so cannot be loaded here.  They mirror halo2_gadgets
``poseidon::primitives`` (Spec, ConstantLength domain, Hash); these digests
feed instance columns, so they must match the reference bit-exactly.

The device sponge (``permute_device``, ``hash_device``; the reference's
lines 152-224) takes the state as a ``(W, 16, B)`` int32 Montgomery tensor,
vectorized over the batch axis B.  On a CUDA tensor each call is one
launch of the ``poseidon_hash`` kernel (:mod:`.cuda_sponge`), the whole
sponge or permutation with the state in registers, where the reference
compiles three ``lax.scan``s over the rounds; on a CPU tensor it runs the
plain versions (``permute_device_plain``, ``hash_device_plain``), those
scans as Python loops of plain field ops.
"""

from __future__ import annotations

import functools

import torch

from ..field.device import DeviceField, get_device_field, plain_field
from ..field.host import PrimeField
from . import cuda_sponge
from .grain import generate_constants


class Spec:
    """Poseidon spec bound to (width, rate); halo2_gadgets `Spec` trait."""

    def __init__(self, width: int, rate: int):
        assert rate == width - 1
        self.width = width
        self.rate = rate

    def full_rounds(self) -> int:
        raise NotImplementedError

    def partial_rounds(self) -> int:
        raise NotImplementedError

    def sbox(self, v):
        return v ** 5

    def secure_mds(self) -> int:
        return 0

    def constants(self, F: type[PrimeField]):
        """(round_constants, mds, mds_inv) as host field elements."""
        rcs, mds, mds_inv = generate_constants(
            F.SPEC, self.width, self.full_rounds(), self.partial_rounds(), self.secure_mds()
        )
        wrap = lambda rows: [[F(v) for v in row] for row in rows]  # noqa: E731
        return wrap(rcs), wrap(mds), wrap(mds_inv)


class MySpec(Spec):
    """The reference's MySpec (src/chips/poseidon/spec.rs): 8 full + 56
    partial rounds, x^5 sbox, secure_mds = 0, any width/rate."""

    def full_rounds(self) -> int:
        return 8

    def partial_rounds(self) -> int:
        return 56


class P128Pow5T3(MySpec):
    """halo2_gadgets' hardcoded width-3 spec; its constants are exactly the
    grain-generated ones for (t=3, 8, 56), so MySpec<3,2> coincides with it."""

    def __init__(self):
        super().__init__(3, 2)


class ConstantLength:
    """ConstantLength<L> domain: zero-pad to a multiple of RATE; capacity
    element encodes the length as L << 64."""

    def __init__(self, L: int):
        self.L = L

    def initial_capacity_element(self, F):
        return F.from_u128(self.L << 64)

    def padding(self, F, rate: int):
        k = (self.L + rate - 1) // rate
        return [F.zero()] * (k * rate - self.L)


def permute(state: list, spec: Spec, mds, round_constants):
    """Host permutation on field elements; halo2_gadgets primitives::permute."""
    width = spec.width
    r_f = spec.full_rounds() // 2
    r_p = spec.partial_rounds()

    def apply_mds(st):
        return [
            sum((mds[i][j] * st[j] for j in range(width)), start=type(st[0]).zero())
            for i in range(width)
        ]

    def full_round(st, rcs):
        return apply_mds([spec.sbox(w + rc) for w, rc in zip(st, rcs)])

    def part_round(st, rcs):
        st = [w + rc for w, rc in zip(st, rcs)]
        st[0] = spec.sbox(st[0])
        return apply_mds(st)

    rounds = [full_round] * r_f + [part_round] * r_p + [full_round] * r_f
    for f, rcs in zip(rounds, round_constants):
        state = f(state, rcs)
    return state


class Hash:
    """Out-of-circuit Poseidon hash (halo2_gadgets primitives::Hash) for
    ConstantLength domains."""

    def __init__(self, F: type[PrimeField], spec: Spec, domain: ConstantLength):
        self.F = F
        self.spec = spec
        self.domain = domain
        self.rcs, self.mds, self.mds_inv = spec.constants(F)

    @classmethod
    def init(cls, F, spec: Spec, domain: ConstantLength) -> "Hash":
        return cls(F, spec, domain)

    def hash(self, message):
        F, spec = self.F, self.spec
        assert len(message) == self.domain.L
        words = list(message) + self.domain.padding(F, spec.rate)
        state = [F.zero()] * spec.rate + [self.domain.initial_capacity_element(F)]
        for chunk_start in range(0, len(words), spec.rate):
            chunk = words[chunk_start : chunk_start + spec.rate]
            for i, w in enumerate(chunk):
                state[i] = state[i] + w
            state = permute(state, spec, self.mds, self.rcs)
        return state[0]


def poseidon_hash(F, spec: Spec, message) -> PrimeField:
    """Convenience one-shot hash with ConstantLength<len(message)>."""
    return Hash(F, spec, ConstantLength(len(message))).hash(message)


# --------------------------------------------------------------------------
# Device (batched) permutation
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_constants(field_spec, width, r_f_total, r_p, secure_mds, device: torch.device):
    """Round constants (R, W, 16, 1) and MDS matrix (W, W, 16, 1) as
    Montgomery int32 tensors on ``device``: each entry a (16, 1) column that
    broadcasts over the batch."""
    rcs, mds, _ = generate_constants(field_spec, width, r_f_total, r_p, secure_mds)
    df = get_device_field(field_spec)

    def table(rows):
        flat = df.encode([v for row in rows for v in row], device=device)  # (16, rows * W)
        return flat.reshape(16, len(rows), width).permute(1, 2, 0).unsqueeze(-1).contiguous()

    return table(rcs), table(mds)


def _permute_loop(d: DeviceField, spec: Spec, state: torch.Tensor) -> torch.Tensor:
    """The permutation as a loop of field ops on ``d``: a round is W
    round-constant adds, the x^5 sbox (two squares and a multiply) on W
    words (full round) or one (partial round), and the MDS product: W^2
    multiplies and W (W - 1) adds."""
    W = spec.width
    r_f = spec.full_rounds() // 2
    r_p = spec.partial_rounds()
    rc_dev, mds_dev = _device_constants(
        d.spec, W, spec.full_rounds(), r_p, spec.secure_mds(), state.device
    )

    def sbox(x):
        x2 = d.square(x)
        return d.mul(d.square(x2), x)

    def apply_mds(st):
        out = []
        for i in range(W):
            acc = d.mul(st[0], mds_dev[i, 0])
            for j in range(1, W):
                acc = d.add(acc, d.mul(st[j], mds_dev[i, j]))
            out.append(acc)
        return out

    st = list(state.unbind(0))
    for r in range(2 * r_f + r_p):
        st = [d.add(st[i], rc_dev[r, i]) for i in range(W)]
        if r_f <= r < r_f + r_p:  # partial round
            st[0] = sbox(st[0])
        else:
            st = [sbox(w) for w in st]
        st = apply_mds(st)
    return torch.stack(st)


def _hash_loop(d: DeviceField, spec: Spec, L: int, messages: torch.Tensor) -> torch.Tensor:
    """The ConstantLength<L> sponge as a loop of field ops on ``d``."""
    B = messages.shape[-1]
    rate = spec.rate
    k = (L + rate - 1) // rate
    state = messages.new_zeros((spec.width, 16, B))
    state[rate] = d.encode([L << 64], device=messages.device)  # the capacity element
    padded = torch.cat([messages, messages.new_zeros((k * rate - L, 16, B))])
    for c in range(k):
        chunk = padded[c * rate : (c + 1) * rate]
        for i in range(rate):
            state[i] = d.add(state[i], chunk[i])
        state = _permute_loop(d, spec, state)
    return state[0]


def permute_device_plain(df: DeviceField, spec: Spec, state: torch.Tensor) -> torch.Tensor:
    """:func:`permute_device` in plain torch ops on the state's device (the
    field ops of ``plain_field(df.spec)``, no kernel): the port's loop
    before ``poseidon_hash``, the reference's ``lax.scan``s."""
    return _permute_loop(plain_field(df.spec), spec, state)


def hash_device_plain(df: DeviceField, spec: Spec, L: int, messages: torch.Tensor) -> torch.Tensor:
    """:func:`hash_device` in plain torch ops on the messages' device."""
    return _hash_loop(plain_field(df.spec), spec, L, messages)


def permute_device(df: DeviceField, spec: Spec, state: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon permutation: state (W, 16, B) Montgomery limbs ->
    the same shape.  On a CUDA tensor one ``poseidon_hash`` launch (widths
    3 and 5); on a CPU tensor :func:`permute_device_plain`."""
    if state.dtype != torch.int32 or state.dim() != 3 or state.shape[:2] != (spec.width, 16):
        raise ValueError(f"permute_device: state must be int32 ({spec.width}, 16, B), got {state.dtype} {tuple(state.shape)}")
    if state.device.type == "cpu":
        return permute_device_plain(df, spec, state)
    if state.device.type != "cuda":
        raise ValueError(f"permute_device: unsupported device {state.device}")
    return cuda_sponge.launch(df.spec, spec, state.contiguous(), spec.width, hash_mode=False)


def hash_device(df: DeviceField, spec: Spec, L: int, messages: torch.Tensor) -> torch.Tensor:
    """Batched ConstantLength<L> hash: messages (L, 16, B) Montgomery limbs
    -> digests (16, B).  On a CUDA tensor one ``poseidon_hash`` launch
    (widths 3 and 5); on a CPU tensor :func:`hash_device_plain`."""
    if messages.shape[0] != L:
        raise ValueError(f"hash_device: {messages.shape[0]} message words, ConstantLength<{L}>")
    if messages.dtype != torch.int32 or messages.dim() != 3 or messages.shape[1] != 16:
        raise ValueError(f"hash_device: messages must be int32 (L, 16, B), got {messages.dtype} {tuple(messages.shape)}")
    if messages.device.type == "cpu":
        return hash_device_plain(df, spec, L, messages)
    if messages.device.type != "cuda":
        raise ValueError(f"hash_device: unsupported device {messages.device}")
    return cuda_sponge.launch(df.spec, spec, messages.contiguous(), L, hash_mode=True)

"""The expression VM as one launch: the compiled instruction table, the
CUDA kernel's plain PyTorch version, and the wrapper that picks one by the
tensors' device.

The kernel (``csrc/vm.cu``) has no Pallas counterpart: it replaces the
reference's VM, ``halo2_tpu/plonkish/evaluator.py:_run_program``, a
``lax.scan`` over the instruction table inside one jitted program.  Here
:func:`compile_program` turns a :class:`.evaluator.Program` into flat int32
tables once (cached per program and field); :func:`vm_eval` runs them over
every row in one launch for CUDA tensors, and :func:`vm_eval_plain` (int64
torch ops, one instruction at a time) for CPU tensors; there is no fallback
between the two.  ``LAUNCHES`` counts kernel launches.

The table:

- queries: ``(kind, column, rotation)`` as the program lists them; row i of
  a query reads row ``(i + rotation * rot_scale) mod n`` of its column, as
  ``jnp.roll(column, -rotation * rot_scale)`` does in the reference;
- constants: ``(C, 8)`` Montgomery words;
- instructions: ``(I, 4)`` int32 ``(op, src1, src2, dst)``, op 0 = add, 1 =
  multiply, 2 = negate (src1 only); a source is ``tag | index << 2`` with
  tag 0 = query, 1 = constant, 2 = register; dst is a register;
- outputs: ``(O,)`` sources, which may be a bare query or constant.

Registers are allocated by liveness: an instruction's operands whose last
reader it is are freed before its result takes a register (the lowest free
one), so the result may reuse an operand's register (both operands are read
before the store); an output stays live to the end.
"""

from __future__ import annotations

import heapq
import weakref

import numpy as np
import torch

from ..field.cuda_mul import modulus_words, mont_mul_plain
from ..field.cuda_ops import ARITH, arith, mod_add_plain, mod_neg_plain
from ..field.params import NUM_LIMBS, FieldSpec

L = NUM_LIMBS
WORDS = 8
LAUNCHES = {"vm_eval": 0}
# opcodes, as evaluator.Program numbers them, and source tags
OP_ADD, OP_MUL, OP_NEG = 0, 1, 2
SRC_QUERY, SRC_CONST, SRC_REG = 0, 1, 2
_MAX_INDEX = 1 << 29  # a source's index, shifted left by 2, stays an int32


class VMTable:
    """A :class:`.evaluator.Program` compiled for one field (see the module
    docstring); device copies of its instructions, outputs and constants
    are made once per device."""

    def __init__(self, spec: FieldSpec, queries, rot_scale: int, consts, instrs, outputs, num_regs: int):
        self.spec = spec
        self.queries = list(queries)
        self.rot_scale = rot_scale
        self.consts = consts  # (C, 8) uint32
        self.instrs = instrs  # (I, 4) int32
        self.outputs = outputs  # (O,) int32
        self.num_regs = num_regs
        self._device: dict = {}

    def shifts(self, n: int) -> list[int]:
        """Each query's row shift over n rows, in [0, n)."""
        return [rot * self.rot_scale % n for _kind, _col, rot in self.queries]

    def consts_on(self, device) -> torch.Tensor:
        """The constants as a ``(C, 8)`` int32 tensor of Montgomery words on
        ``device``, copied once."""
        return self._on(device)[0]

    def _on(self, device):
        device = torch.device(device)
        hit = self._device.get(device)
        if hit is None:
            hit = tuple(
                torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)
                for x in (self.consts, self.instrs, self.outputs)
            )
            self._device[device] = hit
        return hit


def _tag(slot: int, nq: int, nc: int, reg_of) -> int:
    """A Program slot -> a tagged source of the compiled table."""
    if slot < nq:
        return SRC_QUERY | slot << 2
    if slot < nq + nc:
        return SRC_CONST | (slot - nq) << 2
    return SRC_REG | reg_of[slot - nq - nc] << 2


def _words(spec: FieldSpec, v: int) -> list[int]:
    """v in Montgomery form as 8 little-endian 32-bit words."""
    m = v % spec.p * spec.r % spec.p
    return [(m >> (32 * k)) & 0xFFFFFFFF for k in range(WORDS)]


def _compile(prog, spec: FieldSpec) -> VMTable:
    nq, nc, ni = len(prog.queries), len(prog.consts), len(prog.instrs)
    base = nq + nc
    if max(nq, nc, ni) >= _MAX_INDEX:
        raise ValueError(f"vm: program too large ({nq} queries, {nc} constants, {ni} instructions)")
    outs = prog.output_slots()
    last = [-1] * ni  # the last instruction that reads each result; ni: an output
    for j, (op, s1, s2) in enumerate(prog.instrs):
        for s in (s1,) if op == OP_NEG else (s1, s2):
            if s >= base:
                last[s - base] = j
    for s in outs:
        if s >= base:
            last[s - base] = ni
    reg_of = [0] * ni
    free: list[int] = []
    num_regs = 0
    instrs = np.zeros((ni, 4), np.int32)
    for j, (op, s1, s2) in enumerate(prog.instrs):
        if op not in (OP_ADD, OP_MUL, OP_NEG):
            raise ValueError(f"vm: unknown opcode {op} at instruction {j}")
        t1, t2 = _tag(s1, nq, nc, reg_of), _tag(s2, nq, nc, reg_of)
        for s in {s1} if op == OP_NEG else {s1, s2}:
            if s >= base and last[s - base] == j:
                heapq.heappush(free, reg_of[s - base])
        if free:
            reg = heapq.heappop(free)
        else:
            reg, num_regs = num_regs, num_regs + 1
        reg_of[j] = reg
        if last[j] < 0:  # read by nothing: free at once
            heapq.heappush(free, reg)
        instrs[j] = (op, t1, t2, reg)
    outputs = np.array([_tag(s, nq, nc, reg_of) for s in outs], np.int32)
    consts = np.array([_words(spec, v) for v in prog.consts], np.uint32).reshape(nc, WORDS)
    return VMTable(spec, prog.queries, prog.rot_scale, consts, instrs, outputs, num_regs)


# compiled tables per (program, field name), dropped with their program
_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def compile_program(prog, spec: FieldSpec) -> VMTable:
    """The program's compiled table for ``spec`` (cached)."""
    per_prog = _TABLES.setdefault(prog, {})
    table = per_prog.get(spec.name)
    if table is None:
        table = _compile(prog, spec)
        per_prog[spec.name] = table
    return table


# ------------------------------------------------------------- plain version
def _const_limbs(consts: torch.Tensor) -> torch.Tensor:
    """(C, 8) int32 words -> (16, C) int32 limbs."""
    w = consts.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(-1, L)  # (C, 16)
    return limbs.t().to(torch.int32)


def vm_eval_plain(table: VMTable, queries, consts: torch.Tensor, n: int) -> torch.Tensor:
    """The table's outputs over n rows, ``(O, 16, n)`` int32, in plain
    torch ops: each query rolled by its shift, then one instruction at a
    time with :func:`.cuda_mul.mont_mul_plain` and the plain add and negate
    of :mod:`..field.cuda_ops`.  ``queries``: one tensor per query that
    expands to ``(16, n)``; ``consts``: :meth:`VMTable.consts_on`."""
    spec = table.spec
    q = []
    for t, s in zip(queries, table.shifts(n)):
        t = t.expand(L, n)
        q.append(torch.roll(t, -s, dims=-1) if s else t)
    c = _const_limbs(consts)
    regs: list = [None] * table.num_regs

    def fetch(src: int) -> torch.Tensor:
        tag, idx = src & 3, src >> 2
        if tag == SRC_QUERY:
            return q[idx]
        if tag == SRC_CONST:
            return c[:, idx : idx + 1]
        return regs[idx]

    for op, s1, s2, dst in table.instrs.tolist():
        a = fetch(s1)
        if op == OP_ADD:
            regs[dst] = mod_add_plain(spec, a, fetch(s2))
        elif op == OP_MUL:
            regs[dst] = mont_mul_plain(spec, a, fetch(s2))
        else:
            regs[dst] = mod_neg_plain(spec, a)
    outs = [fetch(s).expand(L, n) for s in table.outputs.tolist()]
    return torch.stack(outs) if outs else consts.new_zeros((0, L, n))


# --------------------------------------------------------------------- wrapper
def _check(table: VMTable, queries, consts: torch.Tensor, n: int) -> torch.device:
    """Raise unless every query is an int32 tensor that expands to (16, n)
    and consts the table's (C, 8) int32 words, all on one device; returns
    it."""
    if len(queries) != len(table.queries):
        raise ValueError(f"vm_eval: {len(queries)} query tensors for {len(table.queries)} queries")
    if n <= 0 or n >= 1 << 31:
        raise ValueError(f"vm_eval: bad row count {n}")
    if consts.dtype != torch.int32 or tuple(consts.shape) != (len(table.consts), WORDS):
        raise ValueError(f"vm_eval: consts must be int32 ({len(table.consts)}, {WORDS}), got {consts.dtype} {tuple(consts.shape)}")
    devices = {consts.device}
    for i, t in enumerate(queries):
        if t.dtype != torch.int32:
            raise TypeError(f"vm_eval: query {i} must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != L or t.shape[1] not in (1, n):
            raise ValueError(f"vm_eval: query {i} must expand to (16, {n}), got {tuple(t.shape)}")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"vm_eval: tensors on several devices {sorted(map(str, devices))}")
    return devices.pop()


def _query_table(table: VMTable, queries, n: int) -> np.ndarray:
    """(Q, 4) int64 entries for the kernel: address, limb stride, row stride
    (0 for one broadcast element), row shift."""
    entries = np.zeros((len(queries), 4), np.int64)
    for i, (t, s) in enumerate(zip(queries, table.shifts(n))):
        t = t.expand(L, n)
        entries[i] = (t.data_ptr(), t.stride(0), t.stride(1), s)
    return entries


def vm_eval(table: VMTable, queries, consts: torch.Tensor, n: int) -> torch.Tensor:
    """The table's outputs over n rows, ``(O, 16, n)`` int32.  ``queries``:
    one int32 tensor per query, ``(16, n)`` or ``(16, 1)``, any strides
    (views of a batch, expanded constants); ``consts``:
    :meth:`VMTable.consts_on`.  CPU tensors: plain version; CUDA tensors: one
    kernel launch."""
    device = _check(table, queries, consts, n)
    if device.type == "cpu":
        return vm_eval_plain(table, queries, consts, n)
    if device.type != "cuda":
        raise ValueError(f"vm_eval: unsupported device {device}")
    from .. import _build

    n_out = len(table.outputs)
    out = torch.empty((n_out, L, n), dtype=torch.int32, device=device)
    if n_out == 0:
        return out
    _, instrs_d, outputs_d = table._on(device)
    consts = consts.contiguous()
    entries = torch.from_numpy(_query_table(table, queries, n)).to(device)
    regs = torch.empty((max(table.num_regs, 1), WORDS, n), dtype=torch.int32, device=device)
    _build.launch(
        "vm_eval", device, entries.data_ptr(), consts.data_ptr(), instrs_d.data_ptr(),
        len(table.instrs), outputs_d.data_ptr(), n_out, regs.data_ptr(), out.data_ptr(), n,
        modulus_words(table.spec).ctypes.data, ARITH[arith(table.spec)],
    )
    LAUNCHES["vm_eval"] += 1
    return out

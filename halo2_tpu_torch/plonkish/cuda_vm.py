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
  ``jnp.roll(column, -rotation * rot_scale)`` does in the reference (a row
  range ``(row0, count)`` evaluates rows row0 .. row0 + count - 1 only);
- constants: ``(C, 8)`` Montgomery words;
- instructions: ``(I, 4)`` int32 ``(op, src1, src2, dst)``, op 0 = add, 1 =
  multiply, 2 = negate (src1 only); a source is ``tag | index << 2`` with
  tag 0 = query, 1 = constant, 2 = register; dst is a register;
- outputs: ``(O,)`` sources, which may be a bare query or constant;
- the schedule: each row's instructions are spread over :data:`STREAMS`
  streams (one warp of the kernel's block each) in phases that a barrier
  ends.  ``offsets[p * streams + s]`` is where stream s of phase p starts in
  the instruction table, which lists them phase by phase, stream by stream;
  run in that order, one after another, the table computes the program
  (:func:`vm_eval_plain` does), since every result read across streams was
  made in an earlier phase.

:func:`_schedule` lists the instructions critical path first, each on the
stream where it can start first (a result of another stream costs a
barrier), then places the fewest barriers that separate every such
producer from its reader.  Registers are then allocated in table order: a
result takes the lowest register whose value every reader has read before
it, as far as the schedule orders them (an earlier phase, or earlier in
the same stream; an instruction's own operands count, since both are read
before the store, so a result may take an operand's register); an output
stays live to the end.  The kernel keeps a block's registers in shared
memory, 32 bytes a register and row: :func:`rows_per_block` sizes the
block.  A program whose registers over :data:`STREAMS` streams would not
fit 32 rows (:data:`MAX_REGS`) is scheduled on one stream in its own order,
which needs the fewest; one that does not fit even so is refused with
``ValueError``.
"""

from __future__ import annotations

import bisect
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
# the kernel's blocks: 64 rows, or 32 when 64 rows of registers do not fit
# the shared memory one block may hold on an H100 (227 KB); each row's
# instructions spread over STREAMS warps
BLOCK_ROWS = (64, 32)
SMEM_MAX = 232448
STREAMS = 4
MAX_REGS = SMEM_MAX // (WORDS * 4 * BLOCK_ROWS[-1])  # 227
# the scheduler's weights, about the cycles of one instruction a warp, and of
# reading another stream's result (a barrier)
_COST = {OP_ADD: 40, OP_MUL: 330, OP_NEG: 40}
_BARRIER = 400


class VMTable:
    """A :class:`.evaluator.Program` compiled for one field (see the module
    docstring); device copies of its instructions, outputs and constants
    are made once per device."""

    def __init__(
        self, spec: FieldSpec, queries, rot_scale: int, consts, instrs, outputs, num_regs: int,
        streams: int, offsets, order,
    ):
        self.spec = spec
        self.queries = list(queries)
        self.rot_scale = rot_scale
        self.consts = consts  # (C, 8) uint32
        self.instrs = instrs  # (I, 4) int32, phase by phase, stream by stream
        self.outputs = outputs  # (O,) int32
        self.num_regs = num_regs
        self.streams = streams
        self.offsets = offsets  # (P * streams + 1,) int32: phase p, stream s from offsets[p * streams + s]
        self.order = order  # (I,) the Program's index of each instruction
        self._device: dict = {}

    @property
    def phases(self) -> int:
        return (len(self.offsets) - 1) // self.streams

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
                for x in (self.consts, self.instrs, self.outputs, self.offsets)
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


def _schedule(ops, deps, users, streams: int):
    """(phase, stream, start) of each instruction: a list schedule over
    ``streams`` streams (critical path first, each on the stream where it
    can start first, a dependency on another stream's result costing
    :data:`_BARRIER`), then the fewest barriers that put every such
    dependency's producer in an earlier phase than its reader.  One stream
    runs the program in its own order."""
    ni = len(ops)
    if streams == 1:
        return [0] * ni, [0] * ni, list(range(ni))
    cost = [_COST[op] for op in ops]
    below = [0] * ni  # the longest path from each instruction to the end
    for j in reversed(range(ni)):
        below[j] = cost[j] + max((below[u] for u in users[j]), default=0)
    waiting = [len(d) for d in deps]
    ready = [(-below[j], j) for j in range(ni) if not waiting[j]]
    heapq.heapify(ready)
    start, end, stream = [0] * ni, [0] * ni, [0] * ni
    avail = [0] * streams
    while ready:
        _, j = heapq.heappop(ready)
        t, s = min(
            (max([avail[s]] + [end[d] + (0 if stream[d] == s else _BARRIER) for d in deps[j]]), s)
            for s in range(streams)
        )
        start[j], end[j], stream[j] = t, t + cost[j], s
        avail[s] = end[j]
        for u in users[j]:
            waiting[u] -= 1
            if not waiting[u]:
                heapq.heappush(ready, (-below[u], u))
    barriers: list[int] = []  # times; a dependency across streams needs one in [end(i), start(j)]
    for right, left in sorted((start[j], end[i]) for j in range(ni) for i in deps[j] if stream[i] != stream[j]):
        if not barriers or barriers[-1] < left:
            barriers.append(right)
    phase = [bisect.bisect_right(barriers, start[j]) for j in range(ni)]
    return phase, stream, start


def _compile(prog, spec: FieldSpec) -> VMTable:
    """The table over :data:`STREAMS` streams, or over one (the program's
    order, the fewest registers) when those streams' registers would not
    fit the kernel's shared memory."""
    table = _compile_streams(prog, spec, STREAMS)
    if table.num_regs > MAX_REGS:
        table = _compile_streams(prog, spec, 1)
    return table


def _compile_streams(prog, spec: FieldSpec, streams: int) -> VMTable:
    nq, nc, ni = len(prog.queries), len(prog.consts), len(prog.instrs)
    base = nq + nc
    if max(nq, nc, ni) >= _MAX_INDEX:
        raise ValueError(f"vm: program too large ({nq} queries, {nc} constants, {ni} instructions)")
    ops = [op for op, _s1, _s2 in prog.instrs]
    for j, op in enumerate(ops):
        if op not in (OP_ADD, OP_MUL, OP_NEG):
            raise ValueError(f"vm: unknown opcode {op} at instruction {j}")
    srcs = [(s1,) if op == OP_NEG else (s1, s2) for op, s1, s2 in prog.instrs]
    deps = [sorted({s - base for s in ss if s >= base}) for ss in srcs]
    users: list[list[int]] = [[] for _ in range(ni)]
    for j, d in enumerate(deps):
        for i in d:
            users[i].append(j)
    outs = prog.output_slots()
    live_out = {s - base for s in outs if s >= base}
    phase, stream, start = _schedule(ops, deps, users, streams)
    order = sorted(range(ni), key=lambda j: (phase[j], stream[j], start[j]))
    pos = [0] * ni
    for k, j in enumerate(order):
        pos[j] = k
    # a result's last accesses: the latest phase that makes or reads it, the
    # streams that do so in that phase, and the last table position there
    last = []
    for v in range(ni):
        at = [v, *users[v]]
        p = max(phase[u] for u in at)
        at = [u for u in at if phase[u] == p]
        last.append((p, {stream[u] for u in at}, max(pos[u] for u in at)))

    def free_for(v: int, j: int) -> bool:
        """Every access to v's register happens before j's store: in an
        earlier phase, or earlier in j's own stream (j itself reads its
        operands before it stores).  An output stays."""
        p, streams_at, at = last[v]
        return v not in live_out and (p < phase[j] or (p == phase[j] and streams_at == {stream[j]} and at <= pos[j]))

    reg_of = [0] * ni
    held: list[int] = []  # register -> the instruction whose result it holds
    instrs = np.zeros((ni, 4), np.int32)
    for k, j in enumerate(order):
        op, s1, s2 = prog.instrs[j]
        t1, t2 = _tag(s1, nq, nc, reg_of), _tag(s2, nq, nc, reg_of)
        reg = next((r for r, v in enumerate(held) if free_for(v, j)), len(held))
        if reg == len(held):
            held.append(j)
        else:
            held[reg] = j
        reg_of[j] = reg
        instrs[k] = (op, t1, t2, reg)
    phases = max(phase, default=0) + 1
    offsets = np.searchsorted(
        [phase[j] * streams + stream[j] for j in order], np.arange(phases * streams + 1)
    ).astype(np.int32)
    outputs = np.array([_tag(s, nq, nc, reg_of) for s in outs], np.int32)
    consts = np.array([_words(spec, v) for v in prog.consts], np.uint32).reshape(nc, WORDS)
    return VMTable(
        spec, prog.queries, prog.rot_scale, consts, instrs, outputs, len(held), streams, offsets, np.array(order)
    )


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


def vm_eval_plain(table: VMTable, queries, consts: torch.Tensor, n: int, rows=None) -> torch.Tensor:
    """The table's outputs over the rows ``rows = (row0, count)`` of n
    (None: all n), ``(O, 16, count)`` int32, in plain torch ops: each query
    read at rows (row0 + i + shift) mod n, then one instruction at a time
    with :func:`.cuda_mul.mont_mul_plain` and the plain add and negate of
    :mod:`..field.cuda_ops`.  ``queries``: one tensor per query that expands
    to ``(16, n)``; ``consts``: :meth:`VMTable.consts_on`."""
    spec = table.spec
    row0, count = _rows(rows, n)
    q = []
    for t, s in zip(queries, table.shifts(n)):
        if t.shape[1] != 1:
            at = (torch.arange(row0, row0 + count, device=t.device) + s) % n
            t = t.index_select(1, at)
        q.append(t)
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
    outs = [fetch(s).expand(L, count) for s in table.outputs.tolist()]
    return torch.stack(outs) if outs else consts.new_zeros((0, L, count))


# --------------------------------------------------------------------- wrapper
def rows_per_block(num_regs: int) -> tuple[int, int]:
    """(rows a block, shared-memory bytes a block) of the kernel for a
    program with ``num_regs`` registers: the first of :data:`BLOCK_ROWS`
    whose registers, ``num_regs`` x 32 bytes a row, fit :data:`SMEM_MAX`.
    Raises ``ValueError`` when not even 32 rows fit: a limit of the kernel."""
    for rows in BLOCK_ROWS:
        smem = num_regs * WORDS * 4 * rows
        if smem <= SMEM_MAX:
            return rows, smem
    raise ValueError(f"vm_eval: {num_regs} registers do not fit the kernel's shared memory (at most {MAX_REGS})")


def _rows(rows, n: int) -> tuple[int, int]:
    """(row0, count) of a row range over n rows; None is every row."""
    if rows is None:
        return 0, n
    row0, count = (int(v) for v in rows)
    if row0 < 0 or count <= 0 or row0 + count > n:
        raise ValueError(f"vm_eval: bad row range {tuple(rows)} of {n} rows")
    return row0, count


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


def vm_eval(table: VMTable, queries, consts: torch.Tensor, n: int, rows=None) -> torch.Tensor:
    """The table's outputs over n rows, ``(O, 16, n)`` int32, or over the
    rows ``rows = (row0, count)`` only, ``(O, 16, count)``: row i of the
    result is row row0 + i of the domain, whose queries read rows
    (row0 + i + shift) mod n (a row-sharded caller passes its block; the
    columns stay whole).  ``queries``: one int32 tensor per query,
    ``(16, n)`` or ``(16, 1)``, any strides (views of a batch, expanded
    constants); ``consts``: :meth:`VMTable.consts_on`.  CPU tensors: plain
    version; CUDA tensors: one kernel launch.  Raises ``ValueError`` for a
    program whose registers the kernel cannot hold (:func:`rows_per_block`),
    on either device."""
    device = _check(table, queries, consts, n)
    row0, count = _rows(rows, n)
    block_rows, _smem = rows_per_block(table.num_regs)
    if device.type == "cpu":
        return vm_eval_plain(table, queries, consts, n, (row0, count))
    if device.type != "cuda":
        raise ValueError(f"vm_eval: unsupported device {device}")
    from .. import _build

    n_out = len(table.outputs)
    out = torch.empty((n_out, L, count), dtype=torch.int32, device=device)
    if n_out == 0:
        return out
    _, instrs_d, outputs_d, offsets_d = table._on(device)
    consts = consts.contiguous()
    entries = torch.from_numpy(_query_table(table, queries, n)).to(device)
    _build.launch(
        "vm_eval", device, entries.data_ptr(), consts.data_ptr(), instrs_d.data_ptr(), offsets_d.data_ptr(),
        table.phases, table.streams, outputs_d.data_ptr(), n_out, table.num_regs, block_rows, out.data_ptr(), n,
        row0, count,
        modulus_words(table.spec).ctypes.data, ARITH[arith(table.spec)],
    )
    LAUNCHES["vm_eval"] += 1
    return out

"""Jacobian group ops on the MSM's path: the CUDA kernels, their plain
PyTorch versions, and the wrappers that pick one by the tensors' device
(port of halo2_tpu/ec/pallas_jac.py).

The kernels (``csrc/jac.cu``) replace ``halo2_tpu/ec/pallas_jac.py``'s
``_madd_kernel`` (mixed Jacobian + affine add) and ``_add_kernel`` (complete
Jacobian add).  They compute the reference's canonical formulas
(``ec/device.py:_jac_madd_jnp`` and ``_jac_add_jnp``) with their P == Q
doubling, so their output equals the plain versions here limb for limb and
the wrappers read nothing back from the card.  A point is a dict ``{x, y,
z}`` of ``(16, *batch)`` int32 Montgomery limb tensors over BN254 Fq; z == 0
marks infinity.  A third kernel, ``jac_horner``, runs the sharded MSM's
Horner combine of window sums (the reference's ``fori_loop`` of doublings
and complete adds, ``halo2_tpu/ec/device.py:597-607``) in one launch, and
a fourth, ``jac_ladder`` (``csrc/ladder.cu``), a per-lane double-and-add
(the reference's ``lax.scan`` ``scalar_mul_batched``, ``:246``) in one
launch, a thread a lane, each lane with its own base; a fifth,
``jac_fixed_base`` (``csrc/ladder.cu``), [s_i] P for one point P every lane
shares, the setup's G tau^i, from a table of P's window multiples: one
mixed add a window a lane and no doubling.
Two more run the device MSM's window-sum rounds over a batch of rows
(``csrc/msm.cu``): ``msm_chunk_acc``, every chunk's rounds of signed mixed
adds in registers (the reference's ``fori_loop`` at
``halo2_tpu/ec/device.py:465``) in one of three schedules that
:func:`acc_plan` picks from the lane count (a chunk a group of four
threads for few lanes, a thread for many, at four or three blocks an SM),
and ``jac_suffix_scan``, the exclusive
suffix sums of each row's chunk totals over tiles (``_excl_suffix_scan``,
``:359``) in one of two schedules that :func:`scan_plan` picks from the
shape: a chunk a group of four threads on a thread-block cluster for few
rows, k chunks a thread for many; their plain versions run the kernels'
association order.

Each add kernel has two variants: ``wide`` (one thread per lane) and
``narrow`` (four warps per 32 lanes splitting each formula's independent
products); :func:`variant` picks one from the lane count.  The plain
versions flag the P == Q lanes and double them in :func:`_double_fixup`,
behind one device -> host read of ``same.any()`` (the reference's
``lax.cond``).  :func:`jac_madd_cuda` / :func:`jac_add_cuda` /
:func:`jac_horner_cuda` / :func:`jac_ladder_cuda` / :func:`jac_fixed_base_cuda` /
:func:`msm_chunk_acc_cuda` /
:func:`jac_suffix_scan_cuda` run the plain versions for CPU tensors and
launch the kernels for CUDA tensors; there is no fallback between the two.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.cuda_mul import check_limbs, modulus_one_words
from ..field.device import PlainField
from ..field.device import plain_field as _plain_field
from ..field.params import BN254_FQ, NUM_LIMBS

L = NUM_LIMBS
LAUNCHES = {"jac_madd": 0, "jac_add": 0, "jac_horner": 0, "jac_ladder": 0, "jac_fixed_base": 0, "msm_chunk_acc": 0,
            "jac_suffix_scan": 0}
# jac_fixed_base's window width w, the kernel's FB_W (csrc/ladder.cu):
# ceil(256 / w) mixed adds a lane over a table of ceil(256 / w) (2^w - 1)
# points (w = 6: 43 adds, 2,709 points, 173,376 bytes); the fastest of the
# sweep of w = 4, 5, 6 on the H100 (scripts/table_probe.py, PERF.md)
FIXED_BASE_WINDOW = 6
SCALAR_WORDS = 8
ENTRY_WORDS = 16  # a table entry: affine x, then y, eight 32-bit words each


def plain_field() -> PlainField:
    """The plain BN254 Fq field the plain group ops run on (no kernel)."""
    return _plain_field(BN254_FQ)


# ------------------------------------------------------------ plain versions
def jac_madd_flagged_plain(p, qx, qy, valid):
    """p + (qx, qy) where ``valid`` else p, without the P == Q doubling;
    returns ``(point, same)``.  The formulas of ``_jac_madd_jnp``
    (madd-2007-bl); (qx, qy) is a finite affine point on valid lanes."""
    d = plain_field()
    x1, y1, z1 = p["x"], p["y"], p["z"]
    z1z1 = d.square(z1)
    u2 = d.mul(qx, z1z1)
    s2 = d.mul(qy, d.mul(z1, z1z1))
    h = d.sub(u2, x1)
    hh = d.square(h)
    i = d.double(d.double(hh))
    j = d.mul(h, i)
    rr = d.double(d.sub(s2, y1))
    v = d.mul(x1, i)
    x3 = d.sub(d.sub(d.square(rr), j), d.double(v))
    y3 = d.sub(d.mul(rr, d.sub(v, x3)), d.double(d.mul(y1, j)))
    z3 = d.sub(d.sub(d.square(d.add(z1, h)), z1z1), hh)

    p_inf = d.is_zero(z1)
    same = valid & d.is_zero(h) & d.is_zero(rr) & ~p_inf
    aff = {"x": qx, "y": qy, "z": d.one_mont(qx.shape[1:], device=qx.device)}
    out = {k: d.select(p_inf, aff[k], v_) for k, v_ in (("x", x3), ("y", y3), ("z", z3))}
    return {k: d.select(valid, out[k], p[k]) for k in out}, same


def jac_add_flagged_plain(p, q):
    """Complete p + q without the P == Q doubling; returns ``(point,
    same)``.  The formulas and selects of ``_jac_add_jnp`` (add-2007-bl):
    P == -Q gives infinity (0, 1, 0), an infinite side returns the other."""
    d = plain_field()
    x1, y1, z1 = p["x"], p["y"], p["z"]
    x2, y2, z2 = q["x"], q["y"], q["z"]
    z1z1 = d.square(z1)
    z2z2 = d.square(z2)
    u1 = d.mul(x1, z2z2)
    u2 = d.mul(x2, z1z1)
    s1 = d.mul(d.mul(y1, z2), z2z2)
    s2 = d.mul(d.mul(y2, z1), z1z1)
    h = d.sub(u2, u1)
    r = d.sub(s2, s1)

    hh = d.square(h)
    i = d.double(d.double(hh))
    j = d.mul(h, i)
    rr = d.double(r)
    v = d.mul(u1, i)
    x3 = d.sub(d.sub(d.square(rr), j), d.double(v))
    y3 = d.sub(d.mul(rr, d.sub(v, x3)), d.double(d.mul(s1, j)))
    z3 = d.mul(d.double(d.mul(z1, z2)), h)

    h_zero, r_zero = d.is_zero(h), d.is_zero(r)
    p_inf, q_inf = d.is_zero(z1), d.is_zero(z2)
    same = h_zero & r_zero & ~p_inf & ~q_inf
    opposite = h_zero & ~r_zero & ~p_inf & ~q_inf
    batch = x3.shape[1:]
    inf = {
        "x": d.zeros(batch, device=x3.device),
        "y": d.one_mont(batch, device=x3.device),
        "z": d.zeros(batch, device=x3.device),
    }
    out = {"x": x3, "y": y3, "z": z3}
    out = {k: d.select(opposite, inf[k], out[k]) for k in out}
    out = {k: d.select(p_inf, q[k], out[k]) for k in out}
    return {k: d.select(q_inf, p[k], out[k]) for k in out}, same


def _double_fixup(out, same, p, d):
    """The (rare) P == Q lanes take jac_double(p), computed only when some
    lane is flagged: one device -> host sync per call."""
    if not bool(same.any()):
        return out
    from .device import jac_double

    dbl = jac_double(p, d)
    return {k: torch.where(same[None], dbl[k], out[k]) for k in out}


def jac_madd_plain(p, qx, qy, valid):
    """Mixed add p + (qx, qy) where ``valid`` else p, in plain torch ops."""
    out, same = jac_madd_flagged_plain(p, qx, qy, valid)
    return _double_fixup(out, same, p, plain_field())


def jac_add_plain(p, q):
    """Complete Jacobian add p + q in plain torch ops."""
    out, same = jac_add_flagged_plain(p, q)
    return _double_fixup(out, same, p, plain_field())


def horner_plain(w, c: int):
    """Stacked ``(3, 16, *B, W)`` window sums -> sum_i 2^(c i) w_i as a jac
    point ``(16, *B)`` in plain torch ops on w's device: from the top window
    down, c doublings (``jac_double``, dbl-2009-l) and one complete add
    (:func:`jac_add_plain`), the reference's ``fori_loop`` Horner
    (``halo2_tpu/ec/device.py:597-607``)."""
    from .device import jac, jac_double, jac_infinity

    d = plain_field()
    acc = jac_infinity(tuple(w.shape[2:-1]), device=w.device)
    for i in reversed(range(w.shape[-1])):
        for _ in range(c):
            acc = jac_double(acc, d)
        acc = jac_add_plain(acc, jac(w[0, ..., i], w[1, ..., i], w[2, ..., i]))
    return acc


def scalar_mul_batched_plain(points, bits):
    """Per-lane double-and-add in plain torch ops on the points' device:
    points a jac dict ``(16, N)``, bits ``(nbits, N)`` rows (nonzero =
    set, LSB first, uint8 or int32).  acc starts at infinity; row r adds
    base where its bit is set (:func:`jac_add_plain`, a select), then
    doubles base (``jac_double``, dbl-2009-l) but after the last row: the
    port's loop before ``jac_ladder``, the reference's ``lax.scan``
    (``halo2_tpu/ec/device.py:246``)."""
    from .device import jac_double, jac_infinity

    d = plain_field()
    n = points["x"].shape[-1]
    acc, base = jac_infinity((n,), device=points["x"].device), points
    for r in range(bits.shape[0]):
        added = jac_add_plain(acc, base)
        bit = bits[r] != 0
        acc = {k: d.select(bit, added[k], acc[k]) for k in acc}
        if r + 1 < bits.shape[0]:
            base = jac_double(base, d)
    return acc


def fixed_base_windows(window: int) -> int:
    """The windows of a 256-bit scalar at width ``window``."""
    return -(-256 // window)


def fixed_base_table(x: int, y: int, window: int) -> np.ndarray:
    """The window multiples of the finite affine point (x, y) (ints over
    BN254 Fq), ``(ceil(256 / w) (2^w - 1), 16)`` uint32: entry (j, d) = d
    2^(w j) (x, y) for d = 1 .. 2^w - 1 at row j (2^w - 1) + d - 1, its
    affine x then y in Montgomery form, eight little-endian 32-bit words
    each.  Host arithmetic (``ec/host.py``): w doublings and 2^w - 2 adds a
    window."""
    from ..field.device import get_device_field
    from . import host

    base, pts = host.g1_from_ints(x, y), []
    for _ in range(fixed_base_windows(window)):
        acc = base
        for _d in range(1, 1 << window):
            pts.append(host.g1_to_ints(acc))
            acc = host.ec_add(acc, base)
        for _ in range(window):
            base = host.ec_double(base)
    limbs = get_device_field(BN254_FQ).encode_np([c for pt in pts for c in pt]).T.reshape(len(pts), 2, L)
    return np.ascontiguousarray((limbs[..., 0::2] | limbs[..., 1::2] << 16).reshape(len(pts), ENTRY_WORDS))


@functools.lru_cache(maxsize=None)
def fixed_base_table_tensor(x: int, y: int, window: int, device) -> torch.Tensor:
    """:func:`fixed_base_table` on ``device`` as int32, made once per point,
    window width and device."""
    return torch.from_numpy(fixed_base_table(x, y, window).view(np.int32)).to(device)


def _table_limbs(table):
    """``(rows, 16)`` packed words -> the x and y limbs, ``(16, rows)``
    int32 each."""
    w = table.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(w.shape[0], 2, L)
    return tuple(limbs[:, c].t().to(torch.int32).contiguous() for c in range(2))


def fixed_base_digits(scalars, window: int):
    """``(8, N)`` scalar words -> ``(ceil(256 / w), N)`` int64 digits:
    window j is bits w j .. w j + w - 1."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    rows = []
    for j in range(fixed_base_windows(window)):
        word, off = divmod(window * j, 32)
        v = s[word] >> off
        if off + window > 32 and word + 1 < SCALAR_WORDS:
            v = v | (s[word + 1] << (32 - off))
        rows.append(v & ((1 << window) - 1))
    return torch.stack(rows)


def fixed_base_mul_plain(table, scalars, window: int = FIXED_BASE_WINDOW):
    """[s_i] P in plain torch ops on the scalars' device, from P's window
    table (:func:`fixed_base_table`, ``(rows, 16)`` int32) and ``(8, N)``
    int32 scalar words: acc starts at infinity, and window j adds entry (j,
    d_j) with :func:`jac_madd_plain` where the digit d_j is not 0, as the
    kernel does.  Returns a jac dict ``(16, N)``."""
    from .device import jac_infinity

    tx, ty = _table_limbs(table)
    digits = fixed_base_digits(scalars, window)
    acc = jac_infinity((scalars.shape[1],), device=scalars.device)
    per = (1 << window) - 1
    for j in range(digits.shape[0]):
        d = digits[j]
        idx = j * per + (d - 1).clamp(min=0)
        acc = jac_madd_plain(acc, tx[:, idx], ty[:, idx], d != 0)
    return acc


def msm_chunk_acc_plain(px, py, order, sign):
    """The MSM's intra-chunk suffix rounds in plain torch ops: lane (r, c)
    of ``order``/``sign`` ``(R, q, C)`` (position-major: entry pos of chunk
    c at ``[r, pos, c]``) starts at infinity and, from entry q - 1 down to
    0, adds the affine point ``(px, py)[:, order[r, pos, c]]`` (y negated
    where ``sign[r, pos, c]``) with :func:`jac_madd_plain`.  Returns ``(sfx,
    tot)``: ``(3, 16, R, q C)`` the running sum after each entry (x, y, z
    stacked; position-major as the entries) and ``(3, 16, R, C)`` the chunk
    totals.  The reference's ``fori_loop`` (``halo2_tpu/ec/device.py:465``)."""
    from .device import jac_infinity

    d = plain_field()
    rows, q, chunks = order.shape
    stacked = torch.cat([px, py])  # (32, n): one gather a round
    valid = torch.ones((rows, chunks), dtype=torch.bool, device=px.device)
    sfx = torch.empty((3, L, rows, q, chunks), dtype=torch.int32, device=px.device)
    acc = jac_infinity((rows, chunks), device=px.device)
    for pos in reversed(range(q)):
        g = stacked[:, order[:, pos].long()]  # (32, R, C)
        qy = d.select(sign[:, pos], d.neg(g[16:]), g[16:])  # the signed digit
        acc = jac_madd_plain(acc, g[:16], qy, valid)
        for i, k in enumerate(("x", "y", "z")):
            sfx[i, :, :, pos] = acc[k]
    return sfx.reshape(3, L, rows, q * chunks), torch.stack([acc["x"], acc["y"], acc["z"]])


def scan_plan(rows: int, chunks: int) -> tuple:
    """The scan's schedule for one level of ``rows`` x ``chunks`` points,
    ``("cluster", 1)`` or ``("coarse", k)``: the first of ``SCAN_PLAN``
    whose most lanes (rows x chunks) the level does not exceed, else
    ``SCAN_PLAN_ABOVE``.  It does not depend on the device, so the plain
    version runs the card's association order."""
    return next((schedule for most, schedule in SCAN_PLAN if rows * chunks <= most), SCAN_PLAN_ABOVE)


def scan_tile(chunks: int, schedule: tuple) -> tuple:
    """``(T, k)``: the chunks a tile of ``schedule`` takes (the power of two
    at or above ``chunks``, up to ``SCAN_TILE`` or, for k chunks a thread,
    ``COARSE_THREADS`` k where that is more) and the chunks a thread, k
    clipped to T."""
    k = schedule[1]
    T = min(max(SCAN_TILE, COARSE_THREADS * k), 1 << max(0, chunks - 1).bit_length())
    return T, min(k, T)


def _stack_add(p, q):
    """p + q of two stacked ``(3, 16, ...)`` points by :func:`jac_add_plain`."""
    r = jac_add_plain({"x": p[0], "y": p[1], "z": p[2]}, {"x": q[0], "y": q[1], "z": q[2]})
    return torch.stack([r["x"], r["y"], r["z"]])


def _scan_tiles_plain(s, T: int, k: int, totals: bool):
    """One tile pass of the suffix scan in plain torch ops: the exclusive
    suffixes of each tile of T chunks (chunks past C infinity) and, with
    ``totals``, the tile sums ``(3, 16, R, ceil(C / T))``, in the kernels'
    order, which T and k alone fix (the cluster schedule's is k = 1's).
    Each of the T / k slots sums its k chunks from the last down, acc =
    c_j + acc; then the Kogge-Stone steps d = 1, 2, .. over the slots, slot
    i taking x[i] + x[i + d] (x[i] first), every read of a step before its
    writes; then each slot walks
    its chunks back from slot i + 1's sum s (infinity for the last slot):
    chunk k - 1 takes s, chunk j - 1 takes s = c_j + s.  k = 1 is plain
    Kogge-Stone over the chunks."""
    from .device import jac_infinity

    rows, chunks = s.shape[2:]
    tiles, t = -(-chunks // T), T // k
    inf = torch.stack(list(jac_infinity((), device=s.device).values()))  # (3, 16)
    x = inf[:, :, None, None].repeat(1, 1, rows, tiles * T)
    x[..., :chunks] = s
    x = x.reshape(3, L, rows, tiles, t, k)
    acc = x[..., k - 1].clone()
    for j in range(k - 2, -1, -1):
        acc = _stack_add(x[..., j], acc)
    d = 1
    while d < t:
        acc[..., : t - d] = _stack_add(acc[..., : t - d], acc[..., d:])
        d *= 2
    run = torch.cat([acc[..., 1:], inf[:, :, None, None, None].expand(3, L, rows, tiles, 1)], dim=-1)
    out = torch.empty_like(x)
    out[..., k - 1] = run
    for j in range(k - 1, 0, -1):
        run = _stack_add(x[..., j], run)
        out[..., j - 1] = run
    excl = out.reshape(3, L, rows, tiles * T)[..., :chunks].contiguous()
    return excl, (acc[..., 0].contiguous() if totals else None)


def _scan_offsets_plain(s, suffix, T: int):
    """out[..., c] = s[..., c] + suffix[..., c // T] in plain torch ops."""
    return _stack_add(s, suffix[..., torch.arange(s.shape[-1], device=s.device) // T])


def _suffix_scan(s, plan, tiles, offsets):
    """The exclusive suffix scan of ``(3, 16, R, C)`` points, each level in
    the schedule ``plan(rows, chunks)`` gives it, through a tile pass
    ``tiles`` and an offsets pass ``offsets`` (the kernels' launches or
    their plain versions): up to one tile a tile pass; above, a tile pass
    with totals, the scan of the totals, and the offsets."""
    rows, chunks = s.shape[2:]
    schedule = plan(rows, chunks)
    T, k = scan_tile(chunks, schedule)
    if chunks <= T:
        return tiles(s, schedule, T, k, False)[0]
    excl, tot = tiles(s, schedule, T, k, True)
    return offsets(excl, _suffix_scan(tot, plan, tiles, offsets), T)


def _plan(schedule):
    """:func:`scan_plan`, or ``schedule`` at every level when it is given."""
    if schedule is None:
        return scan_plan
    if schedule not in SCAN_SCHEDULES:
        raise ValueError(f"jac_suffix_scan: schedule must be one of {SCAN_SCHEDULES}, got {schedule!r}")
    return lambda rows, chunks: schedule


def _scan_plain(s, schedule=None):
    """:func:`jac_suffix_scan_plain` in ``schedule`` at every level (None:
    :func:`scan_plan`'s)."""
    tiles = lambda s, _schedule, T, k, totals: _scan_tiles_plain(s, T, k, totals)  # noqa: E731
    return _suffix_scan(s, _plan(schedule), tiles, _scan_offsets_plain)


def jac_suffix_scan_plain(s):
    """The exclusive suffix sums of ``(3, 16, R, C)`` points over their last
    axis, ``out[..., i] = sum_{j > i} s[..., j]`` (infinity at C - 1), in
    plain torch ops in the kernel's association order (its schedules,
    tiles, steps and operand order: add-2007-bl is not symmetric in its
    Jacobian output)."""
    return _scan_plain(s)


# ------------------------------------------------------------------ wrappers
# Up to this many lanes the narrow variant is the faster (measured on one
# H100, PERF.md): the wide one then fills few of the 132 SMs, and its time is
# one thread's chain of 16 (add) or 11 (madd) dependent products.
NARROW_MAX_LANES = 1 << 13
VARIANTS = {"wide": 0, "narrow": 1}
# The suffix scan's schedules (csrc/msm.cu): a chunk a group of four
# threads, CLUSTER_CHUNKS chunks a block, on a cluster of up to eight
# blocks; or k chunks a thread (k = 1: plain Kogge-Stone).  A tile takes up
# to SCAN_TILE chunks, or COARSE_THREADS k where that is more.
SCAN_SCHEDULES = (("cluster", 1), ("coarse", 1), ("coarse", 2), ("coarse", 4))
CLUSTER_CHUNKS = 32
SCAN_TILE = 256
COARSE_THREADS = 128
# scan_plan's rule, (most lanes, schedule) by a level's lanes (rows x
# chunks), measured on one H100 (PERF.md): the cluster up to one 2^11
# scalar set's 32 x 256; k = 1 up to 16,384 (2^10 at four sets: its 7 steps
# beat k = 2's chain of 8 on a card left half idle); k = 2 up to eight sets
# at 2^11 (65,536); k = 4 above (faster from 2^10 at 20 sets, 81,920, up to
# the 2^18 slice's 360,448).
SCAN_PLAN = ((1 << 13, ("cluster", 1)), (1 << 14, ("coarse", 1)), (1 << 16, ("coarse", 2)))
SCAN_PLAN_ABOVE = ("coarse", 4)
# msm_chunk_acc's schedules (csrc/msm.cu): a lane a group of four threads
# (jac.cuh:madd_group, a chain of 4 product levels a round) or a lane a
# thread (a chain of 11 products) at four blocks an SM, or at three
# ("thread3", held there by a smaller shared memory carveout); each lane's
# points fetched ahead into shared memory.  A lane runs at most ACC_QMAX
# rounds.
ACC_SCHEDULES = ("group", "thread", "thread3")
ACC_QMAX = 16
# acc_plan's rule, (most lanes, schedule) by rows x chunks, measured on one
# H100 (132 SMs; scripts/msm_probe.py, PERF.md): the group up to one 2^11
# scalar set's 8,192 lanes (0.031 ms against the thread's 0.043; 0.023
# against 0.042 at 2,048-4,096); the thread from 16,384 (0.044 against
# 0.061) up to one wave of four 128-lane blocks an SM, 67,584; above that up
# to two waves of three, 101,376, three blocks an SM leave the fuller last
# wave (2^10 at 20 sets, 81,920 lanes: 0.144 ms against 0.165 at four); the
# thread again above, up to the 2^18 slice's 360,448.
ACC_PLAN = ((1 << 13, "group"), (67_584, "thread"), (101_376, "thread3"))
ACC_PLAN_ABOVE = "thread"


def variant(m: int) -> str:
    """The kernel variant for a call over ``m`` lanes."""
    return "narrow" if m <= NARROW_MAX_LANES else "wide"


def _check_points(op: str, batch, points: dict) -> None:
    check_limbs(op, **points)
    for name, t in points.items():
        if tuple(t.shape[1:]) != tuple(batch):
            raise ValueError(f"{op}: {name} has batch {tuple(t.shape[1:])}, expected {tuple(batch)}")


def _launch(kernel: str, ins, which):
    """Launch ``kernel`` over the flattened batch of ``ins`` in variant
    ``which`` (None: :func:`variant` of the lane count); returns the point."""
    from .. import _build

    x = ins[0]
    out = {k: torch.empty_like(x) for k in ("x", "y", "z")}
    m = x.numel() // L
    if m:
        _build.launch(
            kernel, x.device, *(t.data_ptr() for t in ins),
            out["x"].data_ptr(), out["y"].data_ptr(), out["z"].data_ptr(),
            m, modulus_one_words(BN254_FQ).ctypes.data, VARIANTS[which or variant(m)],
        )
        LAUNCHES[kernel] += 1
    return out


def jac_madd_cuda(p, qx, qy, valid):
    """Mixed add p + (qx, qy) where ``valid`` else p, with the P == Q
    doubling: the ``jac_madd`` kernel on CUDA tensors (its variant chosen
    from the lane count), the plain version on CPU ones.  Contiguous int32
    inputs of one batch shape; ``valid`` is a bool tensor of that batch
    shape."""
    return _jac_madd(p, qx, qy, valid)


def _jac_madd(p, qx, qy, valid, which=None):
    """:func:`jac_madd_cuda` in variant ``which`` (None: :func:`variant`);
    the checks that hold every variant to the plain version force one."""
    batch = p["x"].shape[1:]
    _check_points("jac_madd", batch, {"px": p["x"], "py": p["y"], "pz": p["z"], "qx": qx, "qy": qy})
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(batch) or valid.device != qx.device:
        raise ValueError(f"jac_madd: valid must be bool {tuple(batch)} on {qx.device}")
    if qx.device.type == "cpu":
        return jac_madd_plain(p, qx, qy, valid)
    if qx.device.type != "cuda":
        raise ValueError(f"jac_madd: unsupported device {qx.device}")
    ins = [p["x"], p["y"], p["z"], qx, qy, valid.to(torch.int32)]
    return _launch("jac_madd", ins, which)


def jac_add_cuda(p, q):
    """Complete Jacobian add p + q, with the P == Q doubling: the
    ``jac_add`` kernel on CUDA tensors (its variant chosen from the lane
    count), the plain version on CPU ones.  Contiguous int32 inputs of one
    batch shape."""
    return _jac_add(p, q)


def _jac_add(p, q, which=None):
    """:func:`jac_add_cuda` in variant ``which`` (None: :func:`variant`)."""
    batch = p["x"].shape[1:]
    _check_points(
        "jac_add", batch,
        {"px": p["x"], "py": p["y"], "pz": p["z"], "qx": q["x"], "qy": q["y"], "qz": q["z"]},
    )
    if q["x"].device.type == "cpu":
        return jac_add_plain(p, q)
    if q["x"].device.type != "cuda":
        raise ValueError(f"jac_add: unsupported device {q['x'].device}")
    ins = [p["x"], p["y"], p["z"], q["x"], q["y"], q["z"]]
    return _launch("jac_add", ins, which)


def jac_horner_cuda(w, c: int):
    """sum_i 2^(c i) w_i of stacked ``(3, 16, *B, W)`` window sums (x, y, z;
    contiguous int32 Montgomery limbs over Fq) as a jac point ``(16, *B)``:
    the ``jac_horner`` kernel on a CUDA tensor (the whole ladder in one
    launch), :func:`horner_plain` on a CPU one."""
    if w.dtype != torch.int32:
        raise TypeError(f"jac_horner: w must be int32, got {w.dtype}")
    if w.dim() < 3 or w.shape[0] != 3 or w.shape[1] != L:
        raise ValueError(f"jac_horner: w must be (3, 16, *B, W), got {tuple(w.shape)}")
    if not w.is_contiguous():
        raise ValueError("jac_horner: w must be contiguous")
    if c < 0:
        raise ValueError(f"jac_horner: c must be >= 0, got {c}")
    if w.device.type == "cpu":
        return horner_plain(w, c)
    if w.device.type != "cuda":
        raise ValueError(f"jac_horner: unsupported device {w.device}")
    from .. import _build

    batch = tuple(w.shape[2:-1])
    out = torch.empty((3, L) + batch, dtype=torch.int32, device=w.device)
    m = out[0].numel() // L
    if m:
        _build.launch(
            "jac_horner", w.device, w.data_ptr(), out.data_ptr(), m, w.shape[-1], c,
            modulus_one_words(BN254_FQ).ctypes.data,
        )
        LAUNCHES["jac_horner"] += 1
    return {"x": out[0], "y": out[1], "z": out[2]}


def jac_ladder_cuda(points, bits):
    """Per-lane double-and-add of a jac dict ``(16, N)`` by its ``(nbits,
    N)`` bit rows (uint8 or int32, nonzero = set, LSB first): the
    ``jac_ladder`` kernel on CUDA tensors (the whole ladder in one launch;
    it reads uint8 rows, so int32 ones are narrowed first),
    :func:`scalar_mul_batched_plain` on CPU ones."""
    px, py, pz = points["x"], points["y"], points["z"]
    check_limbs("jac_ladder", px=px, py=py, pz=pz)
    if px.dim() != 2 or py.shape != px.shape or pz.shape != px.shape:
        raise ValueError(f"jac_ladder: the points must be (16, N), got {tuple(px.shape)}, {tuple(py.shape)}, {tuple(pz.shape)}")
    if bits.dtype not in (torch.uint8, torch.int32) or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(f"jac_ladder: bits must be a contiguous uint8 or int32 (nbits, N), got {bits.dtype} {tuple(bits.shape)}")
    if bits.shape[1] != px.shape[1] or bits.device != px.device:
        raise ValueError(f"jac_ladder: bits must be (nbits, {px.shape[1]}) on {px.device}, got {tuple(bits.shape)} on {bits.device}")
    if px.device.type == "cpu":
        return scalar_mul_batched_plain(points, bits)
    if px.device.type != "cuda":
        raise ValueError(f"jac_ladder: unsupported device {px.device}")
    from .. import _build

    m = px.shape[1]
    out = torch.empty((3, L, m), dtype=torch.int32, device=px.device)
    if m:
        if bits.dtype != torch.uint8:
            bits = (bits != 0).to(torch.uint8)
        _build.launch(
            "jac_ladder", px.device, px.data_ptr(), py.data_ptr(), pz.data_ptr(), bits.data_ptr(),
            out.data_ptr(), m, bits.shape[0], modulus_one_words(BN254_FQ).ctypes.data,
        )
        LAUNCHES["jac_ladder"] += 1
    return {"x": out[0], "y": out[1], "z": out[2]}


def jac_fixed_base_cuda(table, scalars):
    """[s_i] P for one point P of ``table`` (:func:`fixed_base_table` at
    ``FIXED_BASE_WINDOW``, contiguous int32 ``(rows, 16)``) and the ``(8,
    N)`` contiguous int32 little-endian scalar words: the ``jac_fixed_base``
    kernel on CUDA tensors (one launch), :func:`fixed_base_mul_plain` on CPU
    ones.  Returns a jac dict ``(16, N)``."""
    rows = fixed_base_windows(FIXED_BASE_WINDOW) * ((1 << FIXED_BASE_WINDOW) - 1)
    for name, t, shape in (("table", table, (rows, ENTRY_WORDS)), ("scalars", scalars, None)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"jac_fixed_base: {name} must be a contiguous int32 2-D tensor, got {t.dtype} {tuple(t.shape)}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"jac_fixed_base: table must be {shape}, got {tuple(t.shape)}")
    if scalars.shape[0] != SCALAR_WORDS or table.device != scalars.device:
        raise ValueError(f"jac_fixed_base: scalars must be ({SCALAR_WORDS}, N) on {table.device}, got "
                         f"{tuple(scalars.shape)} on {scalars.device}")
    if scalars.device.type == "cpu":
        return fixed_base_mul_plain(table, scalars)
    if scalars.device.type != "cuda":
        raise ValueError(f"jac_fixed_base: unsupported device {scalars.device}")
    from .. import _build

    m = scalars.shape[1]
    out = torch.empty((3, L, m), dtype=torch.int32, device=scalars.device)
    if m:
        _build.launch(
            "jac_fixed_base", scalars.device, scalars.data_ptr(), table.data_ptr(), out.data_ptr(), m,
            FIXED_BASE_WINDOW, modulus_one_words(BN254_FQ).ctypes.data,
        )
        LAUNCHES["jac_fixed_base"] += 1
    return {"x": out[0], "y": out[1], "z": out[2]}


def acc_plan(rows: int, chunks: int) -> str:
    """``msm_chunk_acc``'s schedule for ``rows`` x ``chunks`` lanes: the
    first of ``ACC_PLAN`` whose most lanes the launch does not exceed, else
    ``ACC_PLAN_ABOVE``.  Every schedule gives the same limbs."""
    return next((schedule for most, schedule in ACC_PLAN if rows * chunks <= most), ACC_PLAN_ABOVE)


def msm_chunk_acc_cuda(px, py, order, sign, schedule=None):
    """The MSM's intra-chunk suffix rounds of ``(R, q, C)`` sorted entries
    (position-major; ``order``: int32 point indices below n, ``sign``:
    bool) over the affine points ``px``, ``py`` ``(16, n)``: ``(sfx (3, 16,
    R, q C), tot (3, 16, R, C))``, every running sum (position-major) and
    the chunk totals.  The ``msm_chunk_acc`` kernel on CUDA tensors (one
    launch in ``schedule``, one of ``ACC_SCHEDULES``, or :func:`acc_plan`'s
    when None; the signed negation and the P == Q doubling inside; the
    points as one ``(n, 32)`` table; q up to ``ACC_QMAX``),
    :func:`msm_chunk_acc_plain` on CPU ones whatever the schedule."""
    if schedule is not None and schedule not in ACC_SCHEDULES:
        raise ValueError(f"msm_chunk_acc: schedule must be one of {ACC_SCHEDULES}, got {schedule!r}")
    check_limbs("msm_chunk_acc", px=px, py=py)
    if px.dim() != 2 or py.shape != px.shape:
        raise ValueError(f"msm_chunk_acc: px, py must be one (16, n) shape, got {tuple(px.shape)}, {tuple(py.shape)}")
    if order.dtype != torch.int32 or order.dim() != 3 or not order.is_contiguous():
        raise ValueError(f"msm_chunk_acc: order must be a contiguous int32 (R, q, C), got {order.dtype} {tuple(order.shape)}")
    if sign.dtype != torch.bool or sign.shape != order.shape or not sign.is_contiguous():
        raise ValueError(f"msm_chunk_acc: sign must be a contiguous bool {tuple(order.shape)}")
    if order.device != px.device or sign.device != px.device:
        raise ValueError(f"msm_chunk_acc: order and sign must be on {px.device}")
    if px.device.type == "cpu":
        return msm_chunk_acc_plain(px, py, order, sign)
    if px.device.type != "cuda":
        raise ValueError(f"msm_chunk_acc: unsupported device {px.device}")
    from .. import _build

    rows, q, chunks = order.shape
    if q > ACC_QMAX:
        raise ValueError(f"msm_chunk_acc: at most {ACC_QMAX} entries a chunk, got {q}")
    sfx = torch.empty((3, L, rows, q * chunks), dtype=torch.int32, device=px.device)
    tot = torch.empty((3, L, rows, chunks), dtype=torch.int32, device=px.device)
    if order.numel():
        pts = torch.cat([px, py]).t().contiguous()  # (n, 32): a point's limbs together
        _build.launch(
            "msm_chunk_acc", px.device, pts.data_ptr(), order.data_ptr(), sign.data_ptr(), sfx.data_ptr(),
            tot.data_ptr(), rows, chunks, q, _ACC_MODES[schedule or acc_plan(rows, chunks)],
            modulus_one_words(BN254_FQ).ctypes.data,
        )
        LAUNCHES["msm_chunk_acc"] += 1
    return sfx, tot


def jac_suffix_scan_cuda(s):
    """The exclusive suffix sums of ``(3, 16, R, C)`` points (x, y, z
    stacked; contiguous int32 Montgomery limbs over Fq) over their last
    axis: the ``jac_suffix_scan`` kernel on a CUDA tensor (each level in
    :func:`scan_plan`'s schedule; one launch up to a tile's chunks, three
    up to a tile's square), :func:`jac_suffix_scan_plain` on a CPU one."""
    return _jac_suffix_scan(s)


def _jac_suffix_scan(s, schedule=None):
    """:func:`jac_suffix_scan_cuda` in ``schedule`` at every level (None:
    :func:`scan_plan`'s); the checks that hold every schedule to the plain
    version force one."""
    plan = _plan(schedule)
    if s.dtype != torch.int32:
        raise TypeError(f"jac_suffix_scan: s must be int32, got {s.dtype}")
    if s.dim() != 4 or s.shape[0] != 3 or s.shape[1] != L:
        raise ValueError(f"jac_suffix_scan: s must be (3, 16, R, C), got {tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("jac_suffix_scan: s must be contiguous")
    if s.device.type == "cpu":
        return _scan_plain(s, schedule)
    if s.device.type != "cuda":
        raise ValueError(f"jac_suffix_scan: unsupported device {s.device}")
    if not s.numel():
        return torch.empty_like(s)
    return _suffix_scan(s, plan, _scan_tiles_cuda, _scan_offsets_cuda)


# the C entries' modes: msm_chunk_acc's schedules; a tile pass of either
# scan schedule, the scan's offsets pass
_ACC_MODES = {"group": 0, "thread": 1, "thread3": 2}
_SCAN_MODES = {"cluster": 0, "offsets": 1, "coarse": 2}


def _scan_launch(s, add, out, tot, T: int, k: int, mode: str) -> None:
    from .. import _build

    rows, chunks = s.shape[2:]
    _build.launch(
        "jac_suffix_scan", s.device, s.data_ptr(), None if add is None else add.data_ptr(), out.data_ptr(),
        None if tot is None else tot.data_ptr(), rows, chunks, T, k, _SCAN_MODES[mode],
        modulus_one_words(BN254_FQ).ctypes.data,
    )
    LAUNCHES["jac_suffix_scan"] += 1


def _scan_tiles_cuda(s, schedule: tuple, T: int, k: int, totals: bool):
    """One tile pass of the scan kernel (:func:`_scan_tiles_plain`)."""
    rows, chunks = s.shape[2:]
    out = torch.empty_like(s)
    tot = torch.empty((3, L, rows, -(-chunks // T)), dtype=torch.int32, device=s.device) if totals else None
    _scan_launch(s, None, out, tot, T, k, schedule[0])
    return out, tot


def _scan_offsets_cuda(s, suffix, T: int):
    """The scan kernel's offsets pass (:func:`_scan_offsets_plain`)."""
    out = torch.empty_like(s)
    _scan_launch(s, suffix, out, None, T, 1, "offsets")
    return out

"""Readings of the msm_chunk_acc kernel (csrc/msm.cu) on one card that
chip_smoke.py does not take on every run:

- ``sweep``: each schedule (``ec.cuda_jac.ACC_SCHEDULES``) forced, held
  limb for limb against the plain rounds and timed (torch.profiler, the
  median launch) at SWEEP's batches, with its share of the bound: the sweep
  that ``ACC_PLAN``'s thresholds are set from;
- ``sass``: each schedule's kernel in the built library's SASS (cuobjdump
  -sass), its instructions by opcode class, static counts over the whole
  kernel (the P == Q doubling's branch included).

From the repository root, on a machine with the card:

    python3 scripts/msm_probe.py [sweep] [sass]    # both without arguments
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# (points, scalar sets) of the sweep: the flagship's commit batches at 2^11
# and the set counts between them, a W = 2 rank's 2^10, the dryrun's 2^9,
# the 2^16 MSM and the 2^18 slice
SWEEP = tuple((1 << 11, b) for b in (1, 2, 3, 4, 6, 8, 16, 20)) + (
    (1 << 10, 1), (1 << 10, 4), (1 << 10, 20), (1 << 9, 1), (1 << 9, 4), (1 << 16, 1), (1 << 18, 1))


def _batches(device, gen, wanted):
    """{(n, sets): (px, py, order, sign, plain sfx and tot, bound)}."""
    from halo2_tpu_torch.ec import cuda_jac

    out = {}
    for n, sets in wanted:
        px, py, order, sign = chip_smoke._msm_batch(device, gen, n, sets)
        want = cuda_jac.msm_chunk_acc_plain(px, py, order, sign)
        bound = chip_smoke._bound(*chip_smoke._chunk_acc_work(px, order, want[0][2]))
        out[(n, sets)] = (px, py, order, sign, want, bound)
    return out


def _time(batch, schedule) -> float:
    from halo2_tpu_torch.ec import cuda_jac

    px, py, order, sign, want, bound = batch
    got = cuda_jac.msm_chunk_acc_cuda(px, py, order, sign, schedule)
    for what, g, w in zip(("sfx", "tot"), got, want):
        chip_smoke._max_abs_err(f"msm_chunk_acc {schedule} {what}", g, w)
    return chip_smoke._kernel_device_ms(
        lambda: cuda_jac.msm_chunk_acc_cuda(px, py, order, sign, schedule),
        f"msm_chunk_acc_{schedule}_kernel", bound[0],
    )


def _label(n: int, sets: int, batch) -> str:
    rows, q, chunks = batch[2].shape
    lanes = rows * chunks
    return f"n=2^{n.bit_length() - 1} B={sets} ({rows} x {chunks} = {lanes} lanes, q={q})"


def sweep(device, gen) -> None:
    from halo2_tpu_torch.ec import cuda_jac

    batches = _batches(device, gen, SWEEP)
    for (n, sets), batch in batches.items():
        bound = batch[5][0]
        ms = {s: _time(batch, s) for s in cuda_jac.ACC_SCHEDULES}
        plan = cuda_jac.acc_plan(*batch[2].shape[::2])
        print(
            f"[probe] sweep {_label(n, sets, batch)}: equal to plain in each schedule; "
            + ", ".join(f"{s} {t:.4f} ms ({bound / t:.1%})" for s, t in ms.items())
            + f"; bound {bound:.6f} ms; acc_plan: {plan}, fastest: {min(ms, key=ms.get)}",
            flush=True,
        )


# opcode classes of the SASS histogram, matched on the opcode's start
SASS_CLASSES = ("IMAD.WIDE", "IMAD.MOV", "IMAD", "IADD3", "SEL", "LOP3", "SHFL", "ISETP", "MOV",
                "LDGSTS", "LDS", "LDG", "STG")


def sass(library) -> None:
    counts = {}
    name = None
    for line in chip_smoke._sass_text(library).splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1]
            name = next((f"msm_chunk_acc_{k}" for k in ("group", "thread3", "thread")
                         if f"msm_chunk_acc_{k}" in fn), None)
            if name:
                counts[name] = dict.fromkeys(SASS_CLASSES + ("other",), 0)
        elif name and line.startswith("/*") and "*/" in line:
            ops = line.split("*/", 1)[1].split()
            if ops and ops[0].startswith("@"):
                ops = ops[1:]
            if not ops or ops[0].startswith("/*"):
                continue
            cls = next((c for c in SASS_CLASSES if ops[0].startswith(c)), "other")
            counts[name][cls] += 1
    for name, c in counts.items():
        print(f"[probe] SASS {name} by opcode: {sum(c.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in c.items() if v), flush=True)


def _ptxas(log: str) -> list:
    """The ptxas lines of the msm_chunk_acc kernels in a build log."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = "msm_chunk_acc" in line
        if keep and ("registers" in line or "spill" in line or "Compiling entry" in line):
            lines.append(line.strip())
    return lines


def main(argv) -> int:
    import torch

    device = chip_smoke.phase_device()
    gen = torch.Generator(device=device)
    gen.manual_seed(0x5EED)
    from halo2_tpu_torch import _build

    _build.lib()
    ptxas = _ptxas(_build.log_path().read_text())
    print("[probe] build: " + " | ".join(ptxas), flush=True)
    for name, (total, wide, other) in chip_smoke._sass_counts(_build.library_path()).items():
        if name.startswith("msm_chunk_acc"):
            print(f"[probe] SASS {name}: {total} instructions, {wide} IMAD.WIDE, "
                  f"{other} other IMAD", flush=True)
    modes = argv or ["sweep", "sass"]
    if "sass" in modes:
        sass(_build.library_path())
    if "sweep" in modes:
        sweep(device, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Two readings of the mont_inv kernel (csrc/inv.cu) on one card that
chip_smoke.py does not take on every run:

- ``sass``: the batch loop of each lane group's kernel in the built
  library's SASS (cuobjdump -sass), its instructions by pipe and a model of
  its issue and dependent-chain clocks;
- ``sweep``: each lane group's device time at 2^10-2^20 elements, the sweep
  that field.cuda_mul.INV_PLAN's thresholds are set from.

From the repository root, on a machine with the card:

    python3 scripts/inv_probe.py [sass] [sweep]    # both without arguments
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# The SASS model of _sass_inv_loops: a fixed-latency integer result is
# ready this many clocks after issue, a shuffle's or shared-memory read's
# this many.
SASS_LATENCY, SASS_MIO_LATENCY = 4, 24
SASS_FMA_OPS = ("IMAD", "FFMA", "FMUL", "FADD")
SASS_ALU_OPS = (
    "IADD3", "LOP3", "SHF", "SEL", "ISETP", "PLOP3", "LEA", "IABS", "IMNMX", "FSEL", "SGXT",
    "BMSK", "PRMT", "P2R", "R2P", "VIADD", "IADD", "ULOP3", "UIADD3",
)
# the element counts at which sweep_inverses times each G
INV_SWEEP = (1 << 10, 1 << 11, 1 << 12, 1 << 13, 3 << 12, 1 << 14, 1 << 15, 1 << 16, 1 << 18,
             1 << 20)
_BRANCH = re.compile(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)")
_REG = re.compile(r"\bU?[RP]\d+\b")


def _kernel_bodies(text: str) -> dict:
    """{"mont_inv G=.. cc|wide": [(address, instruction), ...]} from SASS."""
    funcs, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            name = None
            if "mont_inv" in fn:
                g = re.search(r"Li(\d)E", fn)
                arith = "cc" if "CcArith" in fn else "wide"
                name = f"mont_inv G={g.group(1) if g else '?'} {arith}"
                funcs[name] = []
        elif name and line.startswith("/*") and "*/" in line:
            addr, rest = line[2:].split("*/", 1)
            ins = rest.split(";")[0].strip()
            if ins and not ins.startswith("/*"):
                funcs[name].append((int(addr, 16), ins))
    return funcs


def _sass_inv_loops(library) -> dict:
    """The batch loop of each mont_inv kernel in the built library's SASS
    (the instructions from a backward branch's target to the branch): its
    instructions by pipe and two lower bounds of its clocks for a warp alone
    on its scheduler, the issue (2 clocks a warp instruction on the 16-lane
    ALU or FMA pipe, 4 for IMAD.WIDE, the pipes side by side) and the
    dependent chain through the registers and predicates the loop writes
    (SASS_LATENCY a result, SASS_MIO_LATENCY a shuffle or shared-memory
    read; within one pass).
    A model for reading the measured cycles against, not a measurement."""
    from halo2_tpu_torch.field import cuda_mul

    out = {}
    for name, body in _kernel_bodies(chip_smoke._sass_text(library)).items():
        loops = [(addr, int(m.group(1), 16)) for addr, ins in body
                 for m in [_BRANCH.search(ins)] if m and int(m.group(1), 16) < addr]
        if not loops:
            continue
        end, start = max(loops, key=lambda x: x[0] - x[1])
        loop = [ins for addr, ins in body if start <= addr <= end]
        ready, chain = {}, 0
        n = {"alu": 0, "fma": 0, "wide": 0, "shfl": 0, "other": 0}
        for ins in loop:
            pred = re.match(r"@!?(U?P\w+)\s+", ins)
            op = ins[pred.end():] if pred else ins
            opcode, _, args = op.partition(" ")
            base = opcode.split(".")[0]
            kind = ("shfl" if base == "SHFL" else "fma" if base in SASS_FMA_OPS
                    else "alu" if base in SASS_ALU_OPS else "other")
            n[kind] += 1
            wide = opcode.startswith("IMAD.WIDE")
            n["wide"] += wide
            regs = [r.strip().lstrip("-!|~") for r in args.split(",")]
            carry_out = (len(regs) > 1 and re.fullmatch(r"U?P\d", regs[1] or "")
                         and base in ("IADD3", "LOP3"))
            ndst = 2 if base in ("ISETP", "PLOP3", "SHFL") or carry_out else 1
            dst, src = regs[:ndst], regs[ndst:] + ([pred.group(1)] if pred else [])
            src += [f"R{int(r[1:]) + 1}" for r in src[2:3] if wide and re.fullmatch(r"R\d+", r)]
            src = [m for tok in src for m in _REG.findall(tok)]  # [R30+0x10] reads R30
            t = max([ready.get(r, 0) for r in src], default=0)
            t += SASS_MIO_LATENCY if base in ("SHFL", "LDS") else SASS_LATENCY
            pair = [f"R{int(dst[0][1:]) + 1}"] if wide and re.fullmatch(r"R\d+", dst[0]) else []
            for r in dst + pair:
                if re.fullmatch(r"U?[RP]\d+", r):
                    ready[r] = t
            chain = max(chain, t)
        issue = max(2 * (n["alu"]), 2 * (n["fma"] + n["wide"]), len(loop))
        # a batch reads the jump table INV_JUMPS times: the batches a pass
        reads = sum(1 for ins in loop if re.match(r"(@!?U?P\w+\s+)?LDS", ins))
        steps = cuda_mul.INV_STEPS * max(1, reads // cuda_mul.INV_JUMPS)
        out[name] = {"n": len(loop), **n, "issue": issue, "chain": chain, "steps": steps}
    return out


def sweep_inverses(device) -> None:
    """The mont_inv kernel's device time per launch with each G (BN254 Fr)
    at every INV_SWEEP size, beside its share of the bound and its cycles a
    divstep (at chip_smoke.SM_HZ), and inv_plan's pick: the sweep INV_PLAN
    is set from."""
    import torch

    from halo2_tpu_torch.field import cuda_mul
    from halo2_tpu_torch.field.params import BN254_FR

    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    for m in INV_SWEEP:
        a = chip_smoke._random_field(BN254_FR, (m,), gen, device)
        bound, chain = chip_smoke._inv_bound(m)[0], chip_smoke._inv_work(m)[2]
        cells = []
        for group in cuda_mul.INV_GROUPS:
            t = chip_smoke._kernel_device_ms(
                lambda: cuda_mul._mont_inv(BN254_FR, a, group), "mont_inv_kernel", bound)
            cycles = t * 1e-3 * chip_smoke.SM_HZ / chain
            cells.append(f"G={group} {t:.4f} ms ({bound / t:.2%}, {cycles:.1f} cycles a divstep)")
        print(f"[sweep] mont_inv m={m}: " + "; ".join(cells)
              + f"; inv_plan picks G={cuda_mul.inv_plan(m)}", flush=True)


def main(argv: list) -> int:
    from halo2_tpu_torch import _build

    want = argv or ["sass", "sweep"]
    device = chip_smoke.phase_device()
    _build.lib()
    if "sass" in want:
        for name, loop in _sass_inv_loops(_build.library_path()).items():
            steps = loop["steps"]
            print(
                f"[sass] {name}, the batch loop ({steps} divsteps and their matrix products a "
                f"pass): {loop['n']} instructions, {loop['alu']} on the ALU pipe, {loop['fma']} "
                f"on the FMA pipe ({loop['wide']} IMAD.WIDE), {loop['shfl']} SHFL, "
                f"{loop['other']} other; issue at least {loop['issue']} cycles (a warp "
                f"instruction holds its 16-lane pipe 2 clocks, IMAD.WIDE 4), dependent chain "
                f"{loop['chain']} cycles at {SASS_LATENCY} a result ({SASS_MIO_LATENCY} a SHFL "
                f"or LDS): {loop['issue'] / steps:.1f} / {loop['chain'] / steps:.1f} cycles a "
                "divstep",
                flush=True,
            )
    if "sweep" in want:
        sweep_inverses(device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The two redesigns of jac_ladder (csrc/ladder.cu) that were not kept
(scripts/ladder_variants.cu: a ring of pending bases a lane in shared
memory at depths 4 and 2, and a row's set bits compacted onto the fewest
warps of a block), built with nvcc, held limb for limb against the kernel
on chip_smoke's exception lanes, and each timed beside the kernel in turns
(kernel, variants, variants in reverse, kernel) on ParamsKZG.setup(16)'s
own operands at LADDER_PROBE lanes, beside the bound of the work the bits
need.

From the repository root, on a machine with the card:

    python3 scripts/ladder_probe.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

VARIANTS = {"ring4": 0, "ring2": 1, "compact": 2}
LADDER_PROBE = (1 << 11, 1 << 14, 1 << 16)


def _build():
    """scripts/ladder_variants.cu -> a shared library in the kernels' build
    directory; the ptxas lines of its kernels."""
    from halo2_tpu_torch import _build

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ladder_variants.cu")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    out = _build.BUILD_DIR / "ladder_variants.so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-Xptxas", "-v", "-I", str(_build.CSRC), "-o", str(out), src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stderr)
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ladder_variant.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, vp, vp]
    lib.ladder_variant.restype = i32
    return lib, [ln.strip() for ln in res.stderr.splitlines() if "registers" in ln or "spill" in ln]


def _run(lib, name: str, points, bits):
    import torch

    from halo2_tpu_torch.ec import cuda_jac
    from halo2_tpu_torch.field.cuda_mul import modulus_one_words
    from halo2_tpu_torch.field.params import BN254_FQ

    if name == "kernel":
        return cuda_jac.jac_ladder_cuda(points, bits)
    px, py, pz = points["x"], points["y"], points["z"]
    m = px.shape[1]
    out = torch.empty((3, 16, m), dtype=torch.int32, device=px.device)
    rc = lib.ladder_variant(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), bits.data_ptr(), out.data_ptr(), m,
        bits.shape[0], VARIANTS[name], modulus_one_words(BN254_FQ).ctypes.data,
        torch.cuda.current_stream(px.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ladder_variant {name}: CUDA error {rc}")
    return {"x": out[0], "y": out[1], "z": out[2]}


def main() -> int:
    import torch

    device = chip_smoke.phase_device()
    lib, ptxas = _build()
    print("[probe] ladder_variants.cu: " + " | ".join(ptxas), flush=True)
    p, bits = chip_smoke._ladder_lanes(device, 1 << 11)
    want = _run(lib, "kernel", p, bits)
    for name in VARIANTS:
        got = _run(lib, name, p, bits)
        torch.cuda.synchronize(device)
        for k in ("x", "y", "z"):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{name}: {k} differs from jac_ladder")
    print(f"[probe] {', '.join(VARIANTS)}: equal to jac_ladder limb for limb at 2^11 lanes (0, 1, "
          f"R - 1, an infinity base, P == Q at row 254)", flush=True)
    order = ["kernel", *VARIANTS, *reversed(VARIANTS), "kernel"]
    for m in LADDER_PROBE:
        base, bits = chip_smoke._setup_inputs(device, m)
        bound = chip_smoke._bound(*chip_smoke._ladder_work(bits))[0]
        times = [(name, chip_smoke._events_ms(lambda: _run(lib, name, base, bits), bound, calls=3))
                 for name in order]
        print(f"[probe] m=2^{m.bit_length() - 1} (the setup's operands, bound {bound:.6f} ms), "
              "ms a launch in turns: "
              + "; ".join(f"{name} {t:.4f} ({bound / t:.1%})" for name, t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

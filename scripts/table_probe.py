"""The variants of jac_fixed_base (csrc/ladder.cu) and poseidon_hash
(csrc/poseidon.cu) that were not kept, measured on the card beside the
kernels: scripts/table_variants.cu built with nvcc (other window widths, a
128-register launch bound, the table copied into shared memory or read
through __ldg; that file lists them), each variant and each kernel held
limb for limb against its plain version (jac_fixed_base: fixed_base_mul_plain
at its w on chip_smoke's exception lanes at 2^11; poseidon_hash:
hash_device_plain, BN254 Fr, MySpec(5, 4), L = 4, at 2^11), then timed in
turns (the kernel, the variants, the variants in reverse, the kernel) with
CUDA events: jac_fixed_base on ParamsKZG.setup(16)'s scalars at FB_PROBE
lanes beside each w's bound, poseidon_hash at SPONGE_PROBE lanes beside its
bound.  Printed too: the registers and spills of each kernel and variant
(ptxas), and the table loads in the SASS of each variant that reads through
the read-only path (cuobjdump).

From the repository root, on a machine with the card:

    python3 scripts/table_probe.py
"""

from __future__ import annotations

import ctypes
import os
import random
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# fb_variant's index -> (name, w); the kernel: w = 6 through __ldg, 3
# 128-thread blocks an SM
FB_VARIANTS = {"w4 ldg": (0, 4), "w5 ldg": (1, 5), "w6 ldg 4 blocks": (2, 6), "w4 shared": (3, 4),
               "w5 shared": (4, 5)}
FB_PROBE = (1 << 13, 1 << 14, 1 << 16)
SPONGE_PROBE = (1 << 11, 1 << 16, 1 << 20)


def _ptxas(text: str, want: str) -> list:
    """The registers and spill lines of ptxas -v output for the entries
    whose mangled name holds ``want``."""
    lines, keep = [], False
    for ln in text.splitlines():
        if "Compiling entry" in ln:
            keep = want in ln
            name = ln.split("'")[1] if "'" in ln else ln
        elif keep and ("registers" in ln or "spill" in ln):
            lines.append(f"{name}: " + ln.split("ptxas info    :")[-1].strip())
    return lines


def _build_variants():
    """scripts/table_variants.cu -> (ctypes library, its path, ptxas log)."""
    from halo2_tpu_torch import _build

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "table_variants.cu")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    out = _build.BUILD_DIR / "table_variants.so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-Xptxas", "-v", "-I", str(_build.CSRC), "-o", str(out), src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc table_variants.cu failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fb_variant.argtypes = [i32, vp, vp, vp, i32, vp, vp]
    lib.sponge_ldg.argtypes = [vp, vp, i32, i32, i32, vp, i32, i32, vp, vp, i32, vp]
    lib.fb_variant.restype = lib.sponge_ldg.restype = i32
    return lib, out, proc.stdout + proc.stderr


def _sass_loads(path) -> dict:
    """Mangled function name -> (read-only-path 128-bit loads, other
    128-bit global loads) in its SASS, for fb_variant_kernel and
    sponge_ldg_kernel; {} where cuobjdump is not there."""
    from halo2_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            name = name if ("fb_variant" in name or "sponge_ldg" in name) else None
            if name:
                counts[name] = [0, 0]
        elif name and "LDG.E.128" in ln:
            counts[name][0 if ".CONSTANT" in ln else 1] += 1
    return counts


def _fb_run(lib, name, table, words):
    import torch

    from halo2_tpu_torch.field.cuda_mul import modulus_one_words
    from halo2_tpu_torch.field.params import BN254_FQ

    m = words.shape[1]
    out = torch.empty((3, 16, m), dtype=torch.int32, device=words.device)
    rc = lib.fb_variant(FB_VARIANTS[name][0], words.data_ptr(), table.data_ptr(), out.data_ptr(), m,
                        modulus_one_words(BN254_FQ).ctypes.data,
                        torch.cuda.current_stream(words.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jac_fixed_base {name}: CUDA error {rc}")
    return {"x": out[0], "y": out[1], "z": out[2]}


def _sponge_run(lib, df, spec, L, x):
    import torch

    from halo2_tpu_torch.field.cuda_mul import ARITH, arith, modulus_words
    from halo2_tpu_torch.poseidon import cuda_sponge

    B = x.shape[-1]
    out = torch.empty((16, B), dtype=torch.int32, device=x.device)
    r_p = spec.partial_rounds()
    table = cuda_sponge._table(df.spec, spec.width, spec.full_rounds(), r_p, spec.secure_mds(),
                               x.device)
    cap = cuda_sponge._capacity_words(df.spec, L)
    rc = lib.sponge_ldg(x.data_ptr(), out.data_ptr(), B, L, spec.width, table.data_ptr(),
                        spec.full_rounds() // 2, r_p, modulus_words(df.spec).ctypes.data,
                        cap.ctypes.data, ARITH[arith(df.spec)],
                        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"poseidon_hash ldg: CUDA error {rc}")
    return out


def main() -> int:
    import numpy as np
    import torch

    from halo2_tpu_torch import _build
    from halo2_tpu_torch.ec import cuda_jac
    from halo2_tpu_torch.ec import host as ec
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FR
    from halo2_tpu_torch.kzg.params import scalar_words
    from halo2_tpu_torch.poseidon import MySpec, hash_device, hash_device_plain

    device = chip_smoke.phase_device()
    chip_smoke.phase_build()
    lib, path, log = _build_variants()
    kernel_log = _build.log_path().read_text()
    for label, text, want in (("kernel", kernel_log, "jac_fixed_base"),
                              ("variant", log, "fb_variant"),
                              ("kernel", kernel_log, "poseidon_kernel"),
                              ("variant", log, "sponge_ldg")):
        for ln in _ptxas(text, want):
            print(f"[probe] ptxas {label} {ln}", flush=True)
    for name, (ro, other) in _sass_loads(path).items():
        print(f"[probe] sass {name}: {ro} LDG.E.128.CONSTANT, {other} other LDG.E.128", flush=True)

    gx, gy = ec.g1_to_ints(ec.G1)
    lanes = scalar_words(chip_smoke._fixed_base_lanes(1 << 11, 0xF1B))
    check = torch.from_numpy(lanes.view(np.int32)).to(device)
    tables = {w: cuda_jac.fixed_base_table_tensor(gx, gy, w, device) for w in (4, 5, 6)}
    for name, (_v, w) in FB_VARIANTS.items():
        want = cuda_jac.fixed_base_mul_plain(tables[w], check, window=w)
        got = _fb_run(lib, name, tables[w], check)
        for c in ("x", "y", "z"):
            chip_smoke._max_abs_err(f"jac_fixed_base {name} {c}", got[c], want[c])
    print(f"[probe] jac_fixed_base {', '.join(FB_VARIANTS)}: equal to fixed_base_mul_plain at "
          "its w on 2^11 lanes (0, 1, R - 1, R, 2^255 - R, 2^256 - 1 first)", flush=True)
    tau = random.Random(0xD15C0).randrange(1, ec.R)
    powers = [1] * max(FB_PROBE)
    for i in range(1, len(powers)):
        powers[i] = powers[i - 1] * tau % ec.R
    order = ["kernel", *FB_VARIANTS, *reversed(FB_VARIANTS), "kernel"]
    for m in FB_PROBE:
        words = torch.from_numpy(scalar_words(powers[:m]).view(np.int32)).to(device)
        bounds = {w: chip_smoke._bound(*chip_smoke._fixed_base_work(words, w))[0]
                  for w in (4, 5, 6)}
        times = []
        for name in order:
            if name == "kernel":
                w = cuda_jac.FIXED_BASE_WINDOW
                fn = lambda w=w: cuda_jac.jac_fixed_base_cuda(tables[w], words)  # noqa: E731
            else:
                w = FB_VARIANTS[name][1]
                fn = lambda name=name, w=w: _fb_run(lib, name, tables[w], words)  # noqa: E731
            times.append((name, w, chip_smoke._events_ms(fn, bounds[w], calls=5)))
        print(f"[probe] jac_fixed_base m=2^{m.bit_length() - 1} (the setup's scalars; bound ms "
              f"w=4 {bounds[4]:.6f}, w=5 {bounds[5]:.6f}, w=6 {bounds[6]:.6f}), ms a launch in "
              "turns: " + "; ".join(f"{name} {t:.4f} ({bounds[w] / t:.1%})"
                                    for name, w, t in times), flush=True)

    spec, L, df = MySpec(5, 4), 4, get_device_field(BN254_FR)
    x = chip_smoke._sponge_messages(df.spec, L, 1 << 11, 0x5B2, device)
    want = hash_device_plain(df, spec, L, x)
    chip_smoke._max_abs_err("poseidon_hash kernel", hash_device(df, spec, L, x), want)
    chip_smoke._max_abs_err("poseidon_hash ldg", _sponge_run(lib, df, spec, L, x), want)
    print("[probe] poseidon_hash kernel (shared) and ldg: equal to hash_device_plain at 2^11 lanes",
          flush=True)
    order = ["kernel", "ldg", "ldg", "kernel"]
    for m in SPONGE_PROBE:
        x = chip_smoke._sponge_messages(df.spec, L, m, 0x5B1, device)
        bound = chip_smoke._bound(*chip_smoke._sponge_work(spec, L, m))[0]
        times = []
        for name in order:
            if name == "kernel":
                fn = lambda: hash_device(df, spec, L, x)  # noqa: E731
            else:
                fn = lambda: _sponge_run(lib, df, spec, L, x)  # noqa: E731
            times.append((name, chip_smoke._events_ms(fn, bound, calls=5)))
        print(f"[probe] poseidon_hash MySpec(5, 4) L=4 m=2^{m.bit_length() - 1} (bound "
              f"{bound:.6f} ms), ms a launch in turns: "
              + "; ".join(f"{name} {t:.4f} ({bound / t:.1%})" for name, t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

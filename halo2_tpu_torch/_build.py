"""Build the CUDA kernels under ``csrc/`` into one shared library, at first use.

Route: ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, in parallel) and links them into a shared library with a plain C
interface, loaded with :mod:`ctypes`.  No PyTorch
header is compiled, so a build takes seconds.  The library's name carries a
hash of the sources, so an edited kernel is rebuilt and a stale one is never
loaded.  The output directory ``_build/`` (listed in ``.gitignore``) sits
beside this file; nothing outside the checkout is written or compiled.

Each C entry point launches one kernel on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIB = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libh2t_kernels_{source_digest()}.so"


def log_path() -> Path:
    return BUILD_DIR / f"build_{source_digest()}.log"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"tmp{os.getpid()}"
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}_{source_digest()}.{tag}.o"
        cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _obj, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    tmp = out.with_name(out.name + f".{tag}")
    if not failed:
        cmd = [_nvcc(), *flags, "-shared", "-o", str(tmp), *(str(obj) for _c, obj, _p in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    for _cmd, obj, _proc in jobs:
        obj.unlink(missing_ok=True)
    log_path().write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            argtypes = {
                "mont_mul": [vp, vp, vp, i32, i32, vp, vp],
                "mont_sqr": [vp, vp, i32, vp, vp],
                "ntt_small_stages": [vp, vp, i32, i32, vp, vp, i32, vp],
                "ntt_large_stage": [vp, vp, i32, i32, i32, i32, vp, vp, i32, vp],
                "jac_madd": [vp] * 9 + [i32, vp, i32, vp],
                "jac_add": [vp] * 9 + [i32, vp, i32, vp],
                "mod_add": [vp, vp, vp, i32, i32, vp, i32, vp],
                "mod_sub": [vp, vp, vp, i32, i32, i32, vp, i32, vp],
                "vm_eval": [vp, vp, vp, vp, i32, i32, vp, i32, i32, i32, vp, i32, i32, i32, vp, i32, vp],
            }
            for name, types in argtypes.items():
                fn = getattr(handle, f"h2t_{name}")
                fn.argtypes = types
                fn.restype = i32
            handle.h2t_error_string.argtypes = [i32]
            handle.h2t_error_string.restype = ctypes.c_char_p
            _LIB = handle
        return _LIB


def launch(kernel: str, device, *args) -> None:
    """Call the entry point ``h2t_<kernel>(*args, stream)`` on ``device``'s
    current stream; raise if it reports a CUDA error."""
    import torch

    handle = lib()
    with torch.cuda.device(device):
        rc = getattr(handle, f"h2t_{kernel}")(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = handle.h2t_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")

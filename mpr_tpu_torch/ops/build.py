"""Build and load the CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
Every ``.cu`` file compiles to an object in its own ``nvcc`` process, all
started together, then one ``nvcc -shared`` links them.  The library is
keyed by a hash of the sources and flags and kept under
``build/mpr_tpu_torch/<key>/`` at the root of the checkout, so the first
call that needs a kernel builds it and later calls (and later processes)
load it.  The interpreter kernels read the tape at run time, so no new
tape, capacity or op set ever needs a new build.

Numerics: ``--fmad=false`` and no ``--use_fast_math``, with nvcc's IEEE
defaults for division, square root and denormals kept, so the kernels
round as the plain PyTorch versions and the JAX package do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mpr_tpu_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libmpr_tpu_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, every int c_int.
SIGNATURES = {
    "mpr_interval_shorten": [_P] * 9 + [_I] * 4 + [_P],
    "mpr_compact": [_P] * 9 + [_I] * 3 + [_P],
    "mpr_pixel_eval": [_P] * 13 + [_I] * 3 + [_P],
    "mpr_voxel_eval": [_P] * 13 + [_I] * 4 + [_P],
    "mpr_deriv_eval": [_P] * 13 + [_I] * 3 + [_P],
    "mpr_pixel_eval_v1": [_P] * 7 + [_I] * 4 + [_P],
    "mpr_compact_runs": [_P] * 10 + [_I] * 6 + [_P],
    "mpr_compact_order": [_P] * 10 + [_I] * 4 + [_P],
}


class BuildStats:
    """How this process came by the library: ``compiles`` counts nvcc
    builds, ``loads`` counts libraries loaded, ``seconds`` is the time the
    last one took and ``log`` what nvcc printed (registers, spills)."""
    compiles = 0
    loads = 0
    seconds = 0.0
    log = ""


_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_key() -> str:
    """Hash of every kernel source and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    nvcc = _nvcc()
    cus, _ = _sources()
    tmp = out.parent / f"tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    logs, procs = [], []
    try:
        for src in cus:
            obj = tmp / (src.stem + ".o")
            log = open(tmp / (src.stem + ".log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [nvcc, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 str(obj)], stdout=log, stderr=subprocess.STDOUT))
        rcs = [p.wait() for p in procs]
        text = ""
        for src, log in zip(cus, logs):
            log.seek(0)
            text += f"== {src.name}\n{log.read()}"
        if any(rcs):
            raise RuntimeError(f"nvcc failed:\n{text}")
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(lib_tmp), *[str(tmp / (s.stem + ".o")) for s in cus]],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(lib_tmp, out)
        (out.parent / "build.log").write_text(text)
        return text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set has no
    build yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out = BUILD_ROOT / source_key() / LIB_NAME
        if out.exists():
            log_path = out.parent / "build.log"
            BuildStats.log = log_path.read_text() if log_path.exists() else ""
        else:
            out.parent.mkdir(parents=True, exist_ok=True)
            BuildStats.log = _compile(out)
            BuildStats.compiles += 1
        handle = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BuildStats.loads += 1
        BuildStats.seconds = time.perf_counter() - t0
        _lib = handle
        return _lib

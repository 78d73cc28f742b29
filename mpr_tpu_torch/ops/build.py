"""Build and load the CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (``sm_90a``)
into shared libraries with a plain C interface, loaded with ``ctypes``.
Every ``.cu`` file compiles to an object in its own ``nvcc`` process, all
started together, then one ``nvcc -shared`` links them.  A library is
keyed by a hash of the sources and flags and kept under
``build/mpr_tpu_torch/<key>/`` at the root of the checkout, so the first
call that needs a kernel builds it and later calls (and later processes)
load it.  The interpreter kernels read the tape at run time, so no new
tape, capacity or op set ever needs a new build.

There are two libraries (``LIBRARIES``).  ``main`` holds every kernel,
kernels B, V and D at the launch shapes the render path picks; ``extra``
holds B, V and D at the other shapes (``-DMPR_EXTRA_SHAPES``), which only
a forced launch shape reaches, so the render path's first use does not
compile them.  Kernel A takes every launch shape at run time: both its
instantiations (with and without widening) are in ``main``; so do kernels
C and C2, whose two instantiations each (a warp a row, a block a row) the
render path picks by the plane's length.

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
# library -> (its sources, None for every .cu in csrc/; extra nvcc flags)
LIBRARIES = {"main": (None, ()),
             "extra": (("deriv_eval.cu", "pixel_eval.cu", "voxel_eval.cu"),
                       ("-DMPR_EXTRA_SHAPES",))}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points, one a source (``mpr_<stem of the .cu>``):
# every pointer and the stream as c_void_p, every int c_int.
SIGNATURES = {
    "mpr_interval_shorten": [_P] * 7 + [_I] * 16 + [_P],
    "mpr_compact": [_P] * 9 + [_I] * 6 + [_P],
    "mpr_pixel_eval": [_P] * 13 + [_I] * 10 + [_P],
    "mpr_voxel_eval": [_P] * 13 + [_I] * 9 + [_P],
    "mpr_deriv_eval": [_P] * 13 + [_I] * 12 + [_P],
    "mpr_pixel_eval_v1": [_P] * 7 + [_I] * 4 + [_P],
    "mpr_compact_runs": [_P] * 10 + [_I] * 6 + [_P],
    "mpr_compact_order": [_P] * 10 + [_I] * 7 + [_P],
}


class BuildStats:
    """How this process came by the libraries: ``compiles`` counts nvcc
    builds, ``loads`` counts libraries loaded; ``seconds`` and ``log`` map
    a library's name to the time its build or load took and to what nvcc
    printed for it (registers, spills)."""
    compiles = 0
    loads = 0
    seconds = {}
    log = {}


_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set CUDA_HOME)")


def _sources(name: str = "main"):
    names, _ = LIBRARIES[name]
    cus = sorted(p for p in CSRC.glob("*.cu") if names is None
                 or p.name in names)
    return cus, sorted(CSRC.glob("*.cuh"))


def source_key(name: str = "main") -> str:
    """Hash of the library's kernel sources, headers and flags."""
    h = hashlib.sha256(" ".join(FLAGS + LIBRARIES[name][1]).encode())
    cus, cuhs = _sources(name)
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, out: Path) -> str:
    nvcc = _nvcc()
    cus, _ = _sources(name)
    flags = FLAGS + LIBRARIES[name][1]
    tmp = out.parent / f"tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    logs, procs = [], []
    try:
        for src in cus:
            obj = tmp / (src.stem + ".o")
            log = open(tmp / (src.stem + ".log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-I", str(CSRC), "-c", str(src), "-o",
                 str(obj)], stdout=log, stderr=subprocess.STDOUT))
        rcs = [p.wait() for p in procs]
        text = ""
        for src, log in zip(cus, logs):
            log.seek(0)
            text += f"== {src.name}\n{log.read()}"
        if any(rcs):
            raise RuntimeError(f"nvcc failed:\n{text}")
        lib_tmp = tmp / out.name
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


def lib(name: str = "main") -> ctypes.CDLL:
    """The loaded kernel library ``name`` (``LIBRARIES``), built first if
    this source set has no build yet."""
    with _lock:
        if name in _libs:
            return _libs[name]
        t0 = time.perf_counter()
        out = BUILD_ROOT / source_key(name) / f"libmpr_tpu_torch_{name}.so"
        if out.exists():
            log_path = out.parent / "build.log"
            BuildStats.log[name] = (log_path.read_text()
                                    if log_path.exists() else "")
        else:
            out.parent.mkdir(parents=True, exist_ok=True)
            BuildStats.log[name] = _compile(name, out)
            BuildStats.compiles += 1
        handle = ctypes.CDLL(str(out))
        for src in _sources(name)[0]:
            fn = getattr(handle, "mpr_" + src.stem)
            fn.argtypes = SIGNATURES["mpr_" + src.stem]
            fn.restype = ctypes.c_int
        BuildStats.loads += 1
        BuildStats.seconds[name] = time.perf_counter() - t0
        _libs[name] = handle
        return handle

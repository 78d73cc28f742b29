"""Native (C++) tape compiler, loaded via ctypes.

The port's counterpart of the JAX package's native compiler:
``tape_compiler.cpp`` here is a copy of that package's source, and this
module flattens the port's own ``frontend.tree`` DAG into the arrays it
takes and wraps its output in the port's ``tape.tape.Tape``.  The output is
bit-identical to the Python passes of ``tape/tape.py``; ``compile_tree``
takes this path under ``backend='auto'`` (PERF.md has its times against
the Python passes).

The library builds on first use with ``g++`` (plain C ABI, no PyTorch
headers, so it takes seconds) into
``build/mpr_tpu_torch/native/<hash of the source>/libmpr_tape.so`` at the
root of the checkout.  A build writes a temporary file and renames it into
place, so processes that build it together (test workers) never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "tape_compiler.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "mpr_tpu_torch" / "native")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib_handle = None
_lib_failed = False
_lock = threading.Lock()
# seconds of this process's g++ build of the library (None: none ran, a
# library built before was loaded)
BUILD_SECONDS = None

# Frontend op-family ids; must match tape_compiler.cpp::Family.
_FAMILY = {
    "const": 0, "var-x": 1, "var-y": 2, "var-z": 3,
    "square": 4, "sqrt": 5, "neg": 6, "sin": 7, "cos": 8,
    "asin": 9, "acos": 10, "atan": 11, "exp": 12, "abs": 13, "log": 14,
    "add": 15, "mul": 16, "min": 17, "max": 18,
    "sub": 19, "div": 20,
    "hypot": 21, "addsq": 22,
}


def source_key() -> str:
    """Hash of the C++ source and the compiler flags: the library's
    directory under ``BUILD_ROOT``."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_key() / "libmpr_tape.so"


def build(force: bool = False) -> Optional[str]:
    """Compile the shared library unless it is built; returns its path,
    or None (with one line on stderr) where ``g++`` fails."""
    global BUILD_SECONDS
    so = library_path()
    if so.exists() and not force:
        return str(so)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        BUILD_SECONDS = time.perf_counter() - t0
        return str(so)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"mpr_tpu_torch.native: build failed ({e!r}); "
              "using pure-Python tape compiler", file=sys.stderr)
        return None
    finally:
        if tmp.exists():
            tmp.unlink()


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable."""
    with _lock:
        return _load()


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _lib_failed
    if _lib_handle is not None or _lib_failed:
        return _lib_handle
    so = build()
    if so is None:
        _lib_failed = True
        return None
    try:
        h = ctypes.CDLL(so)
        h.mpr_compile.restype = ctypes.c_int
        h.mpr_compile.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib_handle = h
    except OSError as e:
        print(f"mpr_tpu_torch.native: load failed ({e!r})", file=sys.stderr)
        _lib_failed = True
    return _lib_handle


def flatten_tree(tree):
    """Post-order DAG -> (fams, lhs, rhs, values) int32/f32 arrays.

    Raises TapeError for ops the compiler rejects, with the same message
    as the Python path (parity with reference/src/tape.cpp:182-196)."""
    from ..tape.tape import TapeError, UNSUPPORTED
    ordered = tree.ordered_dfs()
    n = len(ordered)
    fams = np.empty(n, np.int32)
    lhs = np.full(n, -1, np.int32)
    rhs = np.full(n, -1, np.int32)
    vals = np.zeros(n, np.float32)
    index = {}
    fam = _FAMILY
    for i, c in enumerate(ordered):
        index[c.id] = i
        f = fam.get(c.op)
        if f is None:
            if c.op in UNSUPPORTED:
                raise TapeError(
                    f"unimplemented opcode {c.op!r} in tape compiler "
                    "(parity with reference/src/tape.cpp:182-196)")
            raise TapeError(f"no GPU op for {c.op!r}")
        fams[i] = f
        if c.lhs is not None:
            lhs[i] = index[c.lhs.id]
        if c.rhs is not None:
            rhs[i] = index[c.rhs.id]
        if f == 0:
            vals[i] = c.value
    return fams, lhs, rhs, vals


def compile_native(tree, schedule: str = "opruns"):
    """Native compile_tree; returns a Tape or None if the lib is absent."""
    h = lib()
    if h is None:
        return None
    from ..tape.tape import Tape, TapeError
    fams, lhs, rhs, vals = flatten_tree(tree)
    n = len(fams)
    cap = n + 1
    o_ops = np.zeros(cap, np.int32)
    o_outs = np.zeros(cap, np.int32)
    o_lhss = np.zeros(cap, np.int32)
    o_rhss = np.zeros(cap, np.int32)
    o_imms = np.zeros(cap, np.float32)
    o_meta = np.zeros(8, np.int32)

    def call(use_opruns, window):
        return h.mpr_compile(
            fams.ctypes.data, lhs.ctypes.data, rhs.ctypes.data,
            vals.ctypes.data, n, use_opruns, window,
            o_ops.ctypes.data, o_outs.ctypes.data, o_lhss.ctypes.data,
            o_rhss.ctypes.data, o_imms.ctypes.data, o_meta.ctypes.data)

    if schedule == "opruns":
        # window backoff on slot-cap overflow, like tape.py::compile_tree
        rc = -1
        for window in (512, 384, 256, 128, 64, 32, 0):
            rc = call(1 if window else 0, window)
            if rc == 0:
                break
            if rc == -2:
                return None  # internal mismatch: fall back to Python
    else:
        rc = call(0, 0)
    if rc == -1:
        raise TapeError("tape needs more than 224 slots")
    if rc != 0:
        return None
    ln = int(o_meta[0])
    return Tape(
        ops=o_ops[:ln].copy(), outs=o_outs[:ln].copy(),
        lhss=o_lhss[:ln].copy(), rhss=o_rhss[:ln].copy(),
        imms=o_imms[:ln].copy(),
        axis_slots=(int(o_meta[2]), int(o_meta[3]), int(o_meta[4])),
        result_slot=int(o_meta[5]),
        num_slots=int(o_meta[1]),
        num_choices=int(o_meta[6]),
        tree=tree,
    )

"""PyTorch port on the card: each CUDA kernel equals its plain version.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``mpr_tpu``, so it also runs where JAX is not
installed; on the machine with the card run it without the suite's
conftest (which sets up JAX):

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Integer outputs (status, codes, tapes, run headers, gmeta) and the fill
must be equal: the kernels and the plain versions run the same float32
operations, and on the card both reach CUDA's own sinf/cosf/expf/logf.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops.tape_data import TapeData
import mpr_tpu_torch.render
from mpr_tpu_torch.render import pipeline2d
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (all_ops_clauses, random_boxes, random_trees,
                              unpack_codes)

pytestmark = pytest.mark.gpu

_RANDOM = random_trees(T, mpr_tpu_torch.compile_tree, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tape(name):
    if name == "all_ops":
        return Tape.from_arrays(**{k: v for k, v in all_ops_clauses().items()})
    if name == "stress40":
        return mpr_tpu_torch.compile_tree(shapes.stress_2d(40))
    return mpr_tpu_torch.compile_tree(_RANDOM[int(name[len("random"):])])


NAMES = [f"random{i}" for i in range(8)] + ["all_ops", "stress40"]


@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_interval_shorten_kernel_matches_plain(cuda, name, widen):
    tape = _tape(name)
    td = TapeData.from_tape(tape, device=cuda)
    boxes = torch.from_numpy(random_boxes(np.random.default_rng(41), 300,
                                          width=1.0)).to(cuda)
    meta = td.meta()
    st, codes = tk.interval_shorten(meta, td.packed, td.imms, boxes,
                                    s_cap=128, widen=widen)
    pst, pcodes = tk.interval_shorten_plain(meta, td.packed, td.imms, boxes,
                                            s_cap=128, widen=widen)
    torch.cuda.synchronize()
    assert torch.equal(st, pst)
    assert np.array_equal(unpack_codes(codes.cpu(), tape.length),
                          unpack_codes(pcodes.cpu(), tape.length))


def _frame_inputs(tape, size, cuda):
    """Run one frame on the card, recording each kernel's inputs."""
    seen = {}
    wrapped = {}
    for name in ("interval_shorten", "compact_bitshift_batched",
                 "pixel_eval_runs"):
        fn = getattr(tk, name)

        def rec(*a, _fn=fn, _name=name, **k):
            seen[_name] = (a, k)
            return _fn(*a, **k)
        wrapped[name] = fn
        setattr(tk, name, rec)
    try:
        td = TapeData.from_tape(tape, device=cuda)
        img, _ = pipeline2d.render_tile_block(
            td, torch.eye(3, device=cuda), torch.tensor(0.0, device=cuda),
            size)
    finally:
        for name, fn in wrapped.items():
            setattr(tk, name, fn)
    return img, seen


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2"])
@pytest.mark.parametrize("size", [256, 1024])
def test_compact_and_pixel_kernels_match_plain(cuda, name, size):
    img, seen = _frame_inputs(_tape(name), size, cuda)
    a, k = seen["compact_bitshift_batched"]
    n_amb = int(a[0][0])
    got = tk.compact_bitshift_batched(*a, **k)
    want = tk.compact_bitshift_batched_plain(*a, **k)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[:n_amb], w[:n_amb])
    assert torch.equal(got[3][:n_amb, :3], want[3][:n_amb, :3])
    a, k = seen["pixel_eval_runs"]
    fill = tk.pixel_eval_runs(*a, **k)
    pfill = tk.pixel_eval_runs_plain(*a, **k)
    assert torch.equal(fill, pfill)


@pytest.mark.parametrize("name", ["circle", "camera", "union", "stress600"])
def test_render2d_cuda_matches_plain_on_card(cuda, name):
    """The whole frame through the kernels equals the frame through the
    plain versions, both on the card."""
    mat = None
    if name == "circle":
        t = shapes.circle(0.8)
    elif name == "camera":
        t = shapes.circle(0.5, 0.2, 0.1)
        mat = np.array([[0.63, -0.14, 0.035], [0.14, 0.63, -0.07], [0, 0, 1]],
                       np.float32)
    elif name == "union":
        t = shapes.union(shapes.circle(0.5, cx=-0.3),
                         shapes.rectangle(0.1, 0.6, -0.2, 0.4))
    else:
        t = shapes.stress_2d(600)
    tape = mpr_tpu_torch.compile_tree(t)
    img = mpr_tpu_torch.render.render2d(tape, mat=mat, size=512)
    saved = (tk.interval_shorten, tk.compact_bitshift_batched,
             tk.pixel_eval_runs)
    tk.interval_shorten = tk.interval_shorten_plain
    tk.compact_bitshift_batched = tk.compact_bitshift_batched_plain
    tk.pixel_eval_runs = tk.pixel_eval_runs_plain
    try:
        want = mpr_tpu_torch.render.render2d(tape, mat=mat, size=512)
    finally:
        (tk.interval_shorten, tk.compact_bitshift_batched,
         tk.pixel_eval_runs) = saved
    assert np.array_equal(img, want), int((img != want).sum())

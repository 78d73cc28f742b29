"""PyTorch port: sharded renders and fit steps over torch.distributed.

World size 1 (no process group) and two ``gloo`` processes on the CPU,
each rank a process of its own, started by the test with a timeout.  The
sharded renders must equal the one-device renders bit for bit (each rank
renders its own block of tiles through the same code); the sharded
gradients must equal the one-device gradients to a sum-order tolerance,
1e-5 of the largest component (each rank sums its own pixels, then one
all_reduce adds the ranks' sums; measured differences are a few ulp).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpr_tpu_torch
from mpr_tpu_torch import cli
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.parallel import distributed, sharded
from mpr_tpu_torch.render import camera, pipeline2d, pipeline3d, unrolled

from torch_port_cases import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
PROBE_LR = 2.0 ** 20


def test_factor2_matches_mpr_tpu():
    from mpr_tpu.parallel import sharded as jsh
    for n in range(1, 33):
        assert sharded._factor2(n) == jsh._factor2(n)


def test_one_process_mesh_and_init_do_nothing():
    distributed.init()                       # no address: nothing to wire
    distributed.init(None, world_size=1)
    distributed.shutdown()                   # no group: nothing to leave
    m = distributed.global_mesh()
    assert (m.size, m.rank, m.dp, m.sp) == (1, 0, 1, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("engine", ["interp", "unrolled"])
def test_world_size_one_renders_equal_one_device(engine):
    tape2 = mpr_tpu_torch.compile_tree(shapes.stress_2d(8))
    tape3 = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    mat3 = camera.gui3d_view()
    if engine == "interp":
        img = sharded.render2d_sharded(tape2, size=128, device="cpu")
        want = pipeline2d.render2d(tape2, size=128, device="cpu")
        d, n = sharded.render3d_sharded(tape3, mat3, size=128, device="cpu")
        wd, wn = pipeline3d.render3d(tape3, mat3, size=128, device="cpu")
    else:
        img = sharded.render2d_sharded_unrolled(tape2, size=128,
                                                device="cpu")
        want = unrolled.render2d(tape2, size=128, device="cpu")
        d, n = sharded.render3d_sharded_unrolled(tape3, mat3, size=128,
                                                 device="cpu")
        wd, wn = unrolled.render3d(tape3, mat3, size=128, device="cpu")
    assert np.array_equal(img, want)
    assert np.array_equal(d, wd) and np.array_equal(n, wn)


def test_cli_sharded_renders_equal_the_plain_command(tmp_path, capsys):
    for engine in ("interp", "unrolled"):
        a, b = str(tmp_path / f"a_{engine}.png"), str(tmp_path / "b.png")
        base = ["render2d", "stress:8", "--size", "128", "--engine", engine,
                "--device", "cpu"]
        cli.main(base + ["--out", a, "--sharded"])
        cli.main(base + ["--out", b])
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    base = ["render3d", "stress:5", "--size", "64", "--mode", "heightmap",
            "--device", "cpu"]
    cli.main(base + ["--out", str(tmp_path / "s.png"), "--sharded"])
    cli.main(base + ["--out", str(tmp_path / "p.png")])
    assert ((tmp_path / "s_depth.png").read_bytes()
            == (tmp_path / "p_depth.png").read_bytes())
    capsys.readouterr()


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------

_RANK = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.parallel import distributed, sharded
from mpr_tpu_torch.render import camera
rank = int(sys.argv[1])
distributed.init({addr!r}, world_size=2, rank=rank)
mesh = distributed.global_mesh()
assert (mesh.size, mesh.rank, mesh.dp, mesh.sp) == (2, rank, 2, 1)
out = {{}}
t2 = mpr_tpu_torch.compile_tree(shapes.stress_2d(8))
t3 = mpr_tpu_torch.compile_tree(shapes.two_spheres())
m3 = camera.gui3d_view()
out["img_interp"] = sharded.render2d_sharded(t2, size=128, mesh=mesh,
                                             device="cpu")
out["img_unrolled"] = sharded.render2d_sharded_unrolled(
    t2, size=128, mesh=mesh, device="cpu")
for eng, fn in (("interp", sharded.render3d_sharded),
                ("unrolled", sharded.render3d_sharded_unrolled)):
    d, n = fn(t3, m3, size=128, mesh=mesh, device="cpu")
    out["depth_" + eng], out["normals_" + eng] = d, n
tg2 = np.load({targets!r})
lr = {lr!r}
steps = {{
    "scan": (sharded.make_fit_step(64, mesh, lr=lr),
             TapeData.from_tape(t2, device="cpu"), tg2["fill64"]),
    "unrolled": (sharded.make_fit_step_unrolled(t2, 64, mesh, lr=lr,
                                                device="cpu"),
                 t2.imms, tg2["fill64"]),
    "culled": (sharded.make_fit_step_culled(t2, 128, mesh, lr=lr,
                                            device="cpu"),
               t2.imms, tg2["fill128"]),
    "3d": (sharded.make_fit_step_3d(t3, 16, mesh, lr=lr, device="cpu"),
           t3.imms, tg2["depth16"]),
    "window": (sharded.make_fit_step_3d_window(t3, 64, mesh, lr=lr,
                                               device="cpu"),
               t3.imms, tg2["depth64"]),
}}
for name, (step, st, tg) in steps.items():
    loss, new = step(st, tg)
    new = new.imms if hasattr(new, "imms") else new
    out["loss_" + name] = float(loss)
    out["imms_" + name] = new.numpy()
if rank == 0:
    np.savez({result!r}, **out)
distributed.shutdown()
'''


def _targets():
    t2 = mpr_tpu_torch.compile_tree(shapes.stress_2d(9))
    t3 = mpr_tpu_torch.compile_tree(shapes.sphere(0.55, cx=0.05))
    return {"fill64": cli._oracle_fill(t2, 64).astype(np.float32),
            "fill128": cli._oracle_fill(t2, 128).astype(np.float32),
            "depth16": cli._oracle_depth(t3, 16),
            "depth64": cli._oracle_depth(t3, 64)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the rank script in two gloo processes; rank 0's results."""
    d = tmp_path_factory.mktemp("ranks")
    targets = _targets()
    np.savez(d / "targets.npz", **targets)
    # the ranks meet at a file of their own: a port picked here and bound
    # later by rank 0 could be taken in between by another process
    code = _RANK.format(repo=str(REPO), addr=(d / "store").as_uri(),
                        targets=str(d / "targets.npz"),
                        result=str(d / "rank0.npz"), lr=PROBE_LR)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=str(d), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    with np.load(d / "rank0.npz") as z:
        return {k: z[k] for k in z.files}, targets


def test_two_ranks_render_equal_one_device(two_ranks):
    got, _ = two_ranks
    t2 = mpr_tpu_torch.compile_tree(shapes.stress_2d(8))
    t3 = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    m3 = camera.gui3d_view()
    assert np.array_equal(got["img_interp"],
                          pipeline2d.render2d(t2, size=128, device="cpu"))
    assert np.array_equal(got["img_unrolled"],
                          unrolled.render2d(t2, size=128, device="cpu"))
    d, n = pipeline3d.render3d(t3, m3, size=128, device="cpu")
    assert np.array_equal(got["depth_interp"], d)
    assert np.array_equal(got["normals_interp"], n)
    d, n = unrolled.render3d(t3, m3, size=128, device="cpu")
    assert np.array_equal(got["depth_unrolled"], d)
    assert np.array_equal(got["normals_unrolled"], n)


@pytest.mark.parametrize("name", ["scan", "unrolled", "culled", "3d",
                                  "window"])
def test_two_ranks_fit_step_equals_one_device(two_ranks, name):
    got, tg = two_ranks
    from mpr_tpu_torch.ops.tape_data import TapeData
    t2 = mpr_tpu_torch.compile_tree(shapes.stress_2d(8))
    t3 = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    lr = PROBE_LR
    step, st, target, tape = {
        "scan": lambda: (sharded.make_fit_step(64, lr=lr),
                         TapeData.from_tape(t2, device="cpu"), tg["fill64"],
                         t2),
        "unrolled": lambda: (sharded.make_fit_step_unrolled(
            t2, 64, lr=lr, device="cpu"), t2.imms, tg["fill64"], t2),
        "culled": lambda: (sharded.make_fit_step_culled(
            t2, 128, lr=lr, device="cpu"), t2.imms, tg["fill128"], t2),
        "3d": lambda: (sharded.make_fit_step_3d(t3, 16, lr=lr,
                                                device="cpu"),
                       t3.imms, tg["depth16"], t3),
        "window": lambda: (sharded.make_fit_step_3d_window(
            t3, 64, lr=lr, device="cpu"), t3.imms, tg["depth64"], t3),
    }[name]()
    loss, new = step(st, target)
    new = (new.imms if hasattr(new, "imms") else new).numpy()
    n = tape.length
    base = np.asarray(tape.imms, np.float64)
    want = (base - new[:n].astype(np.float64)) / lr
    have = (base - got["imms_" + name][:n].astype(np.float64)) / lr
    assert abs(float(got["loss_" + name]) - float(loss)) <= 1e-6 * abs(
        float(loss))
    assert np.abs(have - want).max() <= GRAD_TOL * np.abs(want).max()
    assert np.abs(want).max() > 0

"""PyTorch port on the card: each CUDA kernel equals its plain version.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``mpr_tpu``, so it also runs where JAX is not
installed; on the machine with the card run it without the suite's
conftest (which sets up JAX):

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Integer outputs (status, codes, tapes, run headers, gmeta) and the fill
must be equal: the kernels and the plain versions run the same float32
operations, and on the card both reach CUDA's own sinf/cosf/expf/logf.
The float outputs of the 3D kernels (field values, gradients) must be
equal too, NaNs in the same places.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops import kernels3d as tk3
from mpr_tpu_torch.ops.tape_data import TapeData
import mpr_tpu_torch.render
from mpr_tpu_torch.render import camera, pipeline2d, pipeline3d
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


# ---------------------------------------------------------------------------
# The 3D path: kernels V and D, and the frame
# ---------------------------------------------------------------------------

def _scene3d(name):
    if name == "two_spheres":
        return shapes.two_spheres(), camera.gui3d_view()
    if name == "gyroid":
        return (shapes.intersection(shapes.gyroid(0.4, 0.08),
                                    shapes.sphere(0.85)),
                camera.gui3d_view(0.5, -0.9, 0.3))
    if name == "extruded_stress":
        return (shapes.extrude_z(shapes.stress_2d(40), -0.4, 0.4),
                camera.gui3d_view())
    if name == "all_ops":
        return None, camera.bench3d_view()
    raise KeyError(name)


def _tape3d(name):
    tree, mat = _scene3d(name)
    if tree is None:
        return _tape(name), mat
    return mpr_tpu_torch.compile_tree(tree), mat


def _frame3d_inputs(tape, mat, size, cuda, **kw):
    """One 3D frame on the card, recording the inputs of V and D."""
    seen = {}
    saved = {}
    for name in ("voxel_eval_3d", "deriv_eval_3d"):
        fn = getattr(tk3, name)

        def rec(*a, _fn=fn, _name=name, **k):
            seen[_name] = (a, k)
            return _fn(*a, **k)
        saved[name] = fn
        setattr(tk3, name, rec)
    try:
        td = TapeData.from_tape(tape, device=cuda)
        out = pipeline3d.render3d_rows(td, torch.as_tensor(mat, device=cuda),
                                       size, **kw)
    finally:
        for name, fn in saved.items():
            setattr(tk3, name, fn)
    return out, seen


def _same(a, b):
    return torch.equal(torch.nan_to_num(a, nan=12345.0),
                       torch.nan_to_num(b, nan=12345.0))


@pytest.mark.parametrize("name", ["two_spheres", "gyroid", "extruded_stress",
                                  "all_ops"])
@pytest.mark.parametrize("slab", [(128, 0, 2), (256, 1, 2)])
def test_voxel_and_deriv_kernels_match_plain(cuda, name, slab):
    size, row0, n_rows = slab
    tape, mat = _tape3d(name)
    (_, _, counts), seen = _frame3d_inputs(tape, mat, size, cuda, row0=row0,
                                           n_rows=n_rows)
    assert counts["n_amb1"] > 0 and counts["n_act"] > 0
    a, k = seen["voxel_eval_3d"]
    vals = tk3.voxel_eval_3d(*a, **k)
    want = tk3.voxel_eval_3d_plain(*a, **k)
    torch.cuda.synchronize()
    n = counts["n_amb1"]
    assert _same(vals[:n], want[:n])
    a, k = seen["deriv_eval_3d"]
    out = tk3.deriv_eval_3d(*a, **k)
    want = tk3.deriv_eval_3d_plain(*a, **k)
    torch.cuda.synchronize()
    n = counts["n_act"]
    assert _same(out[:n], want[:n])


def test_3d_kernels_with_overflowed_rows_match_plain(cuda):
    """A per-row capacity of 128 clauses: the cells keep 43 to 286 of the
    373 clauses, so some overflow it and some do not; the columns keep
    nearly all, so every one overflows.  Overflowed rows run the full tape
    from global memory."""
    from mpr_tpu_torch import config
    tape, mat = _tape3d("extruded_stress")
    with config.override(cap_div=4):
        (_, _, counts), seen = _frame3d_inputs(tape, mat, 128, cuda, row0=0,
                                               n_rows=2)
    for name, n in (("voxel_eval_3d", counts["n_amb1"]),
                    ("deriv_eval_3d", counts["n_act"])):
        a, k = seen[name]
        gmeta = a[11] if name == "voxel_eval_3d" else a[10]
        over = gmeta[:n, 2] != 0
        assert over.any()
        if name == "voxel_eval_3d":
            assert not over.all()
        got = getattr(tk3, name)(*a, **k)
        want = getattr(tk3, name + "_plain")(*a, **k)
        assert _same(got[:n], want[:n])


def test_3d_wrappers_raise_on_bad_inputs(cuda):
    tape, mat = _tape3d("two_spheres")
    _, seen = _frame3d_inputs(tape, mat, 128, cuda, row0=0, n_rows=2)
    a, k = seen["voxel_eval_3d"]
    bad = list(a)
    bad[3] = a[3].double()                        # matf dtype
    with pytest.raises(TypeError):
        tk3.voxel_eval_3d(*bad, **k)
    bad = list(a)
    bad[9] = a[9][:, :-1]                         # ti shape
    with pytest.raises(ValueError):
        tk3.voxel_eval_3d(*bad, **k)
    with pytest.raises(ValueError):
        tk3.voxel_eval_3d(*a, **{**k, "s_cap": 512})
    bad = list(a)
    bad[1] = a[1].cpu()                           # order on another device
    with pytest.raises(ValueError):
        tk3.voxel_eval_3d(*bad, **k)
    a, k = seen["deriv_eval_3d"]
    bad = list(a)
    bad[11] = a[11][:, :-1].contiguous()          # depth_blocks shape
    with pytest.raises(ValueError):
        tk3.deriv_eval_3d(*bad, **k)
    bad = list(a)
    bad[11] = a[11].float()                       # depth_blocks dtype
    with pytest.raises(TypeError):
        tk3.deriv_eval_3d(*bad, **k)


@pytest.mark.parametrize("name", ["two_spheres", "gyroid", "extruded_stress"])
@pytest.mark.parametrize("size", [128, 256])
def test_render3d_matches_brute_on_card(cuda, name, size):
    tape, mat = _tape3d(name)
    before = tk3.deriv_eval_3d.launches
    depth, normals = mpr_tpu_torch.render.render3d(tape, mat=mat, size=size)
    assert tk3.deriv_eval_3d.launches == before + 1
    want = mpr_tpu_torch.render.render3d_brute(tape, mat=mat, size=size)
    assert depth.dtype == np.int32 and np.array_equal(depth, want)
    m = depth > 0
    assert m.any() and not m.all()
    assert np.allclose(np.linalg.norm(normals[m], axis=-1), 1.0, atol=1e-3)
    assert not normals[~m].any()
    d2, none = mpr_tpu_torch.render.render3d(tape, mat=mat, size=size,
                                             with_normals=False)
    assert none is None and np.array_equal(d2, depth)
    assert tk3.deriv_eval_3d.launches == before + 1


# ---------------------------------------------------------------------------
# Kernels B1, C1, C2 (the earlier versions of B and C), on a frame's data
# ---------------------------------------------------------------------------

def _v1_inputs(tape, size, cuda):
    """The 2D frame's kernel A outputs, order and coordinates on the card,
    as the chain A -> C1 -> B1 (and the prepass -> C2) takes them."""
    from mpr_tpu_torch.render.pipeline2d import (TILE, _pixel_coords_2d,
                                                 _shorten_prepass,
                                                 _tile_boxes_2d)
    td = TapeData.from_tape(tape, device=cuda)
    n_side = size // TILE
    eye = torch.eye(3, device=cuda)
    z = torch.tensor(0.0, device=cuda)
    s_cap = max(8, -(-td.num_slots // 8) * 8)
    status, codes = tk.interval_shorten(td.meta(), td.packed, td.imms,
                                        _tile_boxes_2d(n_side, eye, z),
                                        s_cap=s_cap)
    amb = status == tk.ST_AMBIG
    order = torch.argsort((~amb).to(torch.int32), stable=True).to(torch.int32)
    _, remap = tk.build_remap(td.ops_present)
    remap_t = torch.as_tensor(remap, device=cuda)
    planes = _shorten_prepass(codes, td.packed, td.imms, td.length, remap_t)
    return dict(td=td, status=status, codes=codes, order=order,
                n_amb=int(amb.sum()), remap=remap_t, s_cap=s_cap,
                planes=planes, coords=_pixel_coords_2d(n_side, eye, z))


def _cmeta(cuda, *vals):
    m = torch.zeros(8, dtype=torch.int32, device=cuda)
    m[:len(vals)] = torch.tensor(vals, dtype=torch.int32)
    return m


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2"])
@pytest.mark.parametrize("cap_div", [1, 8])
def test_compact_runs_kernel_matches_plain(cuda, name, cap_div):
    f = _v1_inputs(_tape(name), 512, cuda)
    td, n = f["td"], f["n_amb"]
    cap = td.capacity // cap_div
    gcap = f["order"].shape[0]
    args = (_cmeta(cuda, n, td.capacity // 8, cap), td.packed, td.imms,
            f["order"], f["remap"], f["codes"], gcap, cap, cap)
    before = tk.compact_runs.launches
    got = tk.compact_runs(*args)
    assert tk.compact_runs.launches == before + 1
    want = tk.compact_runs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[3][:n, :3], want[3][:n, :3])
    gm = got[3][:n].cpu().numpy()
    for g in range(n):
        ln, nr = gm[g, 0], min(gm[g, 1], cap)
        assert torch.equal(got[0][g, :ln], want[0][g, :ln])
        assert torch.equal(got[1][g, :ln].view(torch.int32),
                           want[1][g, :ln].view(torch.int32))
        assert torch.equal(got[2][g, :nr], want[2][g, :nr])


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2",
                                  "random0"])
def test_pixel_eval_kernel_matches_plain(cuda, name):
    f = _v1_inputs(_tape(name), 512, cuda)
    td, n = f["td"], f["n_amb"]
    cap = td.capacity
    gcap = f["order"].shape[0]
    tw, ti, _, gmeta = tk.compact_runs(
        _cmeta(cuda, n, cap // 8, cap), td.packed, td.imms, f["order"],
        f["remap"], f["codes"], gcap, cap, cap)
    # B1 reads its tapes by TILE: scatter the group rows back
    tiles = f["order"][:n].long()
    words = torch.zeros_like(tw)
    imms = torch.zeros_like(ti)
    lens = torch.zeros(gcap, dtype=torch.int32, device=cuda)
    words[tiles], imms[tiles], lens[tiles] = tw[:n], ti[:n], gmeta[:n, 0]
    nmeta = td.meta()
    nmeta[0] = n
    args = (nmeta, f["order"], lens, words, imms, f["coords"])
    before = tk.pixel_eval.launches
    got = tk.pixel_eval(*args, s_cap=f["s_cap"])
    assert tk.pixel_eval.launches == before + 1
    want = tk.pixel_eval_plain(*args, s_cap=f["s_cap"])
    torch.cuda.synchronize()
    assert _same(got[:n], want[:n])
    # and the chain gives the frame's fill on its ambiguous tiles
    img, _ = pipeline2d.render_tile_block(
        td, torch.eye(3, device=cuda), torch.tensor(0.0, device=cuda), 512)
    n_side = 512 // 64
    fill = img.reshape(n_side, 64, n_side, 64).permute(0, 2, 1, 3).reshape(
        n_side * n_side, 4096)
    assert torch.equal(got[:n] < 0, fill[tiles])


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2"])
def test_compact_bitshift_kernel_matches_plain_and_kernel_c(cuda, name):
    f = _v1_inputs(_tape(name), 512, cuda)
    td, n = f["td"], f["n_amb"]
    cap = td.capacity // 8
    gcap = f["order"].shape[0]
    wrw, irw, rem, lens = f["planes"]
    cmeta = _cmeta(cuda, n, cap, cap)
    args = (cmeta, f["order"], lens, wrw, irw, rem, gcap, cap, cap)
    before = tk.compact_bitshift.launches
    got = tk.compact_bitshift(*args)
    assert tk.compact_bitshift.launches == before + 1
    want = tk.compact_bitshift_plain(*args)
    sel = f["order"].long()
    c = tk.compact_bitshift_batched(cmeta, lens[sel].contiguous(),
                                    wrw[sel].contiguous(),
                                    irw[sel].contiguous(),
                                    rem[sel].contiguous(), cap)
    torch.cuda.synchronize()
    for g, w, k in zip(got[:3], want[:3], c[:3]):
        assert torch.equal(g[:n], w[:n]) and torch.equal(g[:n], k[:n])
    assert torch.equal(got[3][:n, :3], want[3][:n, :3])
    assert torch.equal(got[3][:n, :3], c[3][:n, :3])


def test_v1_wrappers_raise_on_bad_inputs(cuda):
    f = _v1_inputs(_tape("stress40"), 256, cuda)
    td = f["td"]
    cap = td.capacity
    gcap = f["order"].shape[0]
    good = (_cmeta(cuda, 1, cap // 8, cap), td.packed, td.imms, f["order"],
            f["remap"], f["codes"], gcap, cap, cap)
    bad = list(good)
    bad[5] = f["codes"].long()
    with pytest.raises(TypeError):
        tk.compact_runs(*bad)
    bad = list(good)
    bad[3] = f["order"].cpu()
    with pytest.raises(ValueError):
        tk.compact_runs(*bad)
    with pytest.raises(ValueError):
        tk.compact_runs(*good[:6], gcap, 1 << 20, cap)
    wrw, irw, rem, lens = f["planes"]
    with pytest.raises(ValueError):
        tk.compact_bitshift(_cmeta(cuda, 1, 64, 64), f["order"], lens, wrw,
                            irw, rem, gcap, cap * 2, cap)
    with pytest.raises(TypeError):
        tk.pixel_eval(td.meta(), f["order"], lens,
                      torch.zeros(gcap, cap, dtype=torch.int32, device=cuda),
                      torch.zeros(gcap, cap, dtype=torch.float64,
                                  device=cuda), f["coords"])


# ---------------------------------------------------------------------------
# Effects and the command line on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["two_spheres", "gyroid"])
@pytest.mark.parametrize("size", [128, 256])
def test_effects_on_the_card_match_the_cpu(cuda, name, size):
    """The same tensors through the effects on the card and on the CPU:
    both run the same IEEE operations, so the images agree to rounding of
    the few library calls that differ (none is expected to)."""
    from mpr_tpu_torch.render import effects
    tape, mat = _tape3d(name)
    depth, normals = mpr_tpu_torch.render.render3d(tape, mat=mat, size=size)
    for mode, scale in (("static", 1), ("gather", 1), ("gather", 2)):
        got = effects.draw_ssao(depth, normals, scale, mode).cpu()
        want = effects.draw_ssao(depth, normals, scale, mode, device="cpu")
        d = (got - want).abs()
        assert float((d > 1e-5).float().mean()) <= 0.01, mode
        assert float(d.max()) <= 0.05, mode
        assert got.min() >= 0 and got.max() <= 1
    got = effects.draw_shaded(depth, normals).cpu()
    want = effects.draw_shaded(depth, normals, device="cpu")
    d = (got - want).abs()
    assert float((d > 1e-5).float().mean()) <= 0.01
    assert float(d.max()) <= 0.05
    m = torch.as_tensor(depth > 0)
    assert not got[~m].any() and got[m].min() >= 0.2 - 1e-6


def test_cli_renders_on_the_card(cuda, tmp_path, capsys):
    from mpr_tpu_torch import cli
    from mpr_tpu_torch.io.png import read_png_gray
    before = tk.pixel_eval_runs.launches
    out = tmp_path / "a.png"
    cli.main(["render2d", "stress:40", "--size", "256", "--check", "--out",
              str(out)])
    assert "mismatch 0.00e+00" in capsys.readouterr().out
    assert tk.pixel_eval_runs.launches == before + 1
    assert read_png_gray(str(out)).shape == (256, 256)
    cli.main(["render3d", "stress:12", "--size", "128", "--out",
              str(tmp_path / "b.png")])
    for suffix in ("depth", "norm", "ssao", "shaded"):
        assert (tmp_path / f"b_{suffix}.png").exists()

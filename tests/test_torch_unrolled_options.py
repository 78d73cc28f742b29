"""PyTorch port: the unrolled 3D ladder's options on the CPU against mpr_tpu's.

The two-phase voxel stage (``UnrolledRenderer.two_phase``), the 2^3
sub-refinement (``_render3d_impl(..., refine2=True)``) and the stops of
``debug_stage`` in ``mpr_tpu_torch.render.unrolled``, held against
``mpr_tpu.render.unrolled``: its renderer with ``two_phase = True``, and its
``_render3d_impl(..., c3=8*c2)`` called eagerly with the caps of
``_caps3d`` after one render (tests/test_unrolled.py calls it so).

Tolerances.  The options change which voxels are evaluated, not their
values, so depth equals the port's single phase, ``mpr_tpu``'s and
``render3d_brute``'s bit for bit; normals equal the port's single phase
bit for bit (the same depth gives the same normals pass) and lie within
1e-4 of ``mpr_tpu``'s (test_torch_unrolled.py's tolerance).  The counts
equal ``mpr_tpu``'s counters.

Scenes: the two ``R3`` scenes of test_torch_unrolled.py under
``gui3d_view``, and ``slabs``, a thin slab in front of a wider one, facing
the camera: the thin slab has no filled 4^3 cell, so its cells do not
occlude the back slab's in the heightmap, but phase 1 fills every pixel of
its columns and phase 2 culls the back slab's cells behind them (the R3
scenes cull none).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.render import unrolled as jun
from mpr_tpu.tape.tape import compile_tree as jcompile

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.ops import unrolled_eval as ue
from mpr_tpu_torch.parallel import sharded
from mpr_tpu_torch.render import brute, camera, unrolled

from torch_port_cases import R3, one_torch_thread  # noqa: F401

SCENES = {name: (build, size, camera.gui3d_view())
          for name, (build, size) in R3.items()}
SCENES["slabs"] = (lambda S: S.union(
    S.box(-0.6, 0.6, -0.6, 0.6, 0.31, 0.325),
    S.box(-0.8, 0.8, -0.8, 0.8, -0.5, -0.1)), 128, camera.identity3())
NAMES = sorted(SCENES)
NORMAL_TOL = 1e-4
# the prefix of the six counts each stop has filled, by option
PREFIX = {"single": {"A": 1, "B": 2, "Bp": 3, "V": 3},
          "two_phase": {"A": 1, "B": 2, "Bp": 4, "V": 4},
          "refine2": {"A": 1, "B": 2, "Bp": 3, "R": 4, "V": 4}}


def _port(name):
    build, size, mat = SCENES[name]
    tape = mpr_tpu_torch.compile_tree(build(shapes))
    return tape, size, mat


def _impl(r, mat, size, **kw):
    return unrolled._render3d_impl(r.fi, r.f, r.fd, torch.as_tensor(mat),
                                   size, True, **kw)


@pytest.fixture(scope="module")
def jax_frames():
    """mpr_tpu's frames of each scene: {name: {"two_phase": (depth,
    normals, counters), "refine2": (depth, normals, counters), "m3":
    debug_stage "R"'s value}}."""
    out = {}
    for name in NAMES:
        build, size, mat = SCENES[name]
        r = jun.UnrolledRenderer(jcompile(build(jshapes)))
        r._obs.clear()
        r._hits.clear()
        r.two_phase = True
        d, nrm = r.render3d(mat=mat, size=size)
        got = {"two_phase": (d, nrm, r._obs[("3d", size)])}
        p0, c1, c2, _, _, pn = r._caps3d(size)
        args = (r.fi, r.f, r.fd, jnp.asarray(mat), size, p0, c1, c2, pn,
                True, False)
        d, nrm, cnt = jun._render3d_impl(*args, c3=8 * c2)
        cnt = tuple(int(v) for v in np.asarray(cnt))
        # the eager call has no overflow retry: its counts fit its caps
        assert (cnt[0] <= p0 and cnt[1] <= c1 and cnt[2] <= c2
                and cnt[3] <= 8 * c2 and cnt[5] <= pn), (cnt, p0, c1, c2, pn)
        got["refine2"] = (np.asarray(d), np.asarray(nrm), cnt)
        got["m3"] = int(np.asarray(jun._render3d_impl(
            *args, debug_stage="R", c3=8 * c2)[2])[0])
        out[name] = got
    return out


@pytest.fixture(scope="module")
def port_frames():
    """The port's single-phase frame and brute render of each scene:
    {name: (depth, normals, counts, brute depth)}."""
    out = {}
    for name in NAMES:
        tape, size, mat = _port(name)
        r = unrolled.UnrolledRenderer(tape)
        d, nrm, cnt = _impl(r, mat, size)
        out[name] = (d.numpy(), nrm.numpy(), cnt,
                     brute.render3d_brute(tape, mat=mat, size=size,
                                          device="cpu"))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_two_phase_equals_the_single_phase_jax_and_brute(
        jax_frames, port_frames, name):
    tape, size, mat = _port(name)
    d1, n1, c1, want = port_frames[name]
    r = unrolled.UnrolledRenderer(tape)
    r.two_phase = True
    depth, normals = r.render3d(mat=mat, size=size, device="cpu")
    jd, jn, jcnt = jax_frames[name]["two_phase"]
    assert depth.dtype == np.int32 and depth.shape == (size, size)
    assert np.array_equal(depth, d1) and np.array_equal(depth, want)
    assert np.array_equal(depth, jd)
    assert np.array_equal(normals, n1)
    np.testing.assert_allclose(normals, jn, atol=NORMAL_TOL, rtol=0)
    n0, na1, n2, na, nb, _ = r._obs[("3d", size)]
    assert (n0, na1, n2, na, nb) == tuple(jcnt[:5])
    assert (n0, na1, n2) == tuple(c1[:3])
    assert 0 < na <= n2 and na + nb <= n2
    if name == "slabs":
        # phase 2 culled cells, exactly
        assert nb < n2 - na


@pytest.mark.parametrize("name", NAMES)
def test_refine2_equals_the_single_phase_jax_and_brute(
        jax_frames, port_frames, name):
    tape, size, mat = _port(name)
    d1, n1, c1, want = port_frames[name]
    depth, normals, cnt = _impl(unrolled.UnrolledRenderer(tape), mat, size,
                                refine2=True)
    depth, normals = depth.numpy(), normals.numpy()
    jd, jn, jcnt = jax_frames[name]["refine2"]
    assert np.array_equal(depth, d1) and np.array_equal(depth, want)
    assert np.array_equal(depth, jd)
    assert np.array_equal(normals, n1)
    np.testing.assert_allclose(normals, jn, atol=NORMAL_TOL, rtol=0)
    assert cnt[:5] == jcnt[:5] and cnt[3] == jax_frames[name]["m3"]
    assert cnt[:3] == c1[:3] and cnt[5] == c1[5]
    assert 0 < cnt[3] <= 8 * cnt[2] and cnt[4] == 0


@pytest.mark.parametrize("option", sorted(PREFIX))
@pytest.mark.parametrize("name", NAMES)
def test_each_stop_counts_a_prefix_of_the_full_ladder(name, option):
    tape, size, mat = _port(name)
    r = unrolled.UnrolledRenderer(tape)
    kw = {} if option == "single" else {option: True}
    _, _, full = _impl(r, mat, size, **kw)
    for stop, k in PREFIX[option].items():
        depth, normals, cnt = _impl(r, mat, size, debug_stage=stop, **kw)
        assert depth is None and normals is None
        assert cnt == full[:k] + (0,) * (6 - k), (stop, cnt, full)


def test_a_stop_the_ladder_does_not_reach_raises():
    tape, size, mat = _port("spheres")
    r = unrolled.UnrolledRenderer(tape)
    for stop, kw in (("R", {}), ("R", {"two_phase": True, "refine2": True}),
                     ("Bp", {"skip4": True}), ("R", {"skip4": True,
                                                     "refine2": True}),
                     ("C", {})):
        with pytest.raises(ValueError, match="debug_stage"):
            _impl(r, mat, size, debug_stage=stop, **kw)


@pytest.mark.parametrize("option", ["two_phase", "refine2"])
@pytest.mark.parametrize("name", ["gyroid", "slabs"])
def test_slabs_of_an_option_stack_to_the_whole_frame(port_frames, name,
                                                     option):
    tape, size, mat = _port(name)
    d1, n1 = port_frames[name][:2]
    r = unrolled.UnrolledRenderer(tape)
    parts = [_impl(r, mat, size, r0=row, rows=1, **{option: True})
             for row in range(size // 64)]
    assert all(d.shape == (64, size) for d, _, _ in parts)
    assert np.array_equal(torch.cat([d for d, _, _ in parts]).numpy(), d1)
    assert np.array_equal(torch.cat([n for _, n, _ in parts]).numpy(), n1)


def test_two_phase_skips_under_skip4_and_frame3d_keeps_its_counts():
    tape, size, mat = _port("slabs")
    r = unrolled.UnrolledRenderer(tape)
    m = torch.as_tensor(mat)
    key = ("3d", size)
    r.frame3d(m, size, skip4=False, two_phase=True)
    two = r._obs[key]
    assert two[3] > 0 and two[4] > 0
    # a single-phase frame, a skip4 frame and one without normals keep the
    # two phases' counts
    r.frame3d(m, size, skip4=False)
    r.frame3d(m, size, with_normals=False, skip4=True, two_phase=True)
    assert r._obs[key][3:] == two[3:] and r._obs[key][:2] == two[:2]
    assert r._obs[key][2] == two[2]
    # steady_frame3d freezes the renderer's two_phase of its making
    r.two_phase = True
    frame = r.steady_frame3d(mat, size, device="cpu")
    r.two_phase = False
    r._obs[key] = r._obs[key][:3] + (-1, -1) + r._obs[key][5:]
    depth, _ = frame(m)
    assert r._obs[key][3:5] == two[3:5]
    assert np.array_equal(depth.numpy(), brute.render3d_brute(
        tape, mat=mat, size=size, device="cpu"))


def test_sharded_two_phase_on_one_process_equals_render3d(port_frames):
    tape, size, mat = _port("slabs")
    r = unrolled.get_renderer(tape)
    r.two_phase = True
    try:
        d, n = sharded.render3d_sharded_unrolled(tape, mat, size=size,
                                                 device="cpu")
        counts = r._obs[("3ds", size, 1)]
    finally:
        r.two_phase = False
    d1, n1 = port_frames["slabs"][:2]
    assert np.array_equal(d, d1) and np.array_equal(n, n1)
    assert counts[4] < counts[2] - counts[3]


@pytest.mark.parametrize("option", ["two_phase", "refine2"])
def test_an_option_in_many_launches_equals_one_pass(monkeypatch, port_frames,
                                                    option):
    """Cut into launches of at most VOXEL_LANES lanes, an option's frame
    equals the one-pass frame, with the launches its counts imply: the
    children's classification in chunks too, under refine2."""
    tape, size, mat = _port("gyroid")
    calls = {"float": 0, "interval": 0}
    for kind in calls:
        real = getattr(ue, f"unrolled_{kind}")

        def counted(*a, _real=real, _kind=kind, **k):
            calls[_kind] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ue, f"unrolled_{kind}", counted)
    monkeypatch.setattr(unrolled, "VOXEL_LANES", 1024 * 8)
    depth, normals, cnt = _impl(unrolled.UnrolledRenderer(tape), mat, size,
                                **{option: True})
    if option == "two_phase":
        want = {"interval": 3,
                "float": unrolled.voxel_launches(cnt[3], 4)
                + unrolled.voxel_launches(cnt[4], 4)}
    else:
        want = {"interval": 3 + unrolled.voxel_launches(cnt[2], 2),
                "float": unrolled.voxel_launches(cnt[3], 2)}
        assert want["interval"] > 4
    assert want["float"] > 2 and calls == want
    d1, n1 = port_frames["gyroid"][:2]
    assert np.array_equal(depth.numpy(), d1)
    assert np.array_equal(normals.numpy(), n1)

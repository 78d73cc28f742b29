"""PyTorch port: SSAO and shading on the CPU against ``mpr_tpu.render.effects``.

Depth and normals come from the port's own ``render3d(..., device="cpu")``
(the capped sphere of tests/test_effects.py at 128 under the identity
camera, and the two spheres at 64 under the GUI camera); the same numpy
arrays then go through both packages' effects.

Tolerance.  ``_shade`` alone is smooth arithmetic: ``atol 1e-6``.  Ambient
occlusion is a sum of threshold tests (``dz < RADIUS``, ``sz <= actual_z``,
the truncation of a sample's pixel index), so a last-place difference
between torch's and XLA's rounding may flip one sample of one pixel and
move it by 1/64 (gather mode) or by one over its in-hemisphere count
(static mode, about 1/64 too); the blur then picks its window by comparing
standard deviations, where a last-place difference can choose another
window.  So every AO image (raw, blurred, ``draw_ssao``) and the shaded
image is held to: within 1e-5 on at least 99.9% of the pixels, and within
2/64 (gather) or 0.05 (static, shaded) everywhere.  Each comparison prints
the count of pixels outside 1e-5.  The suite runs XLA at optimisation level
0 (tests/conftest.py), where that count is 0 on these scenes; at XLA's
default level it contracts the blur's ``s2 / c - mean * mean`` into a fused
multiply-add and 7 to 22 pixels of these images then keep another window
(up to 0.11 apart), which is why the bounds are not set to equality.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from mpr_tpu.render import effects as jeffects

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.render import camera, effects, render3d

from torch_port_cases import one_torch_thread  # noqa: F401

CLOSE = 1e-5
SHARE = 0.999
FAR = {"gather": 2.0 / 64.0, "static": 0.05, "shaded": 0.05}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, tree, mat, size in (
            ("capped_sphere", shapes.capped_sphere(), None, 128),
            ("two_spheres", shapes.two_spheres(), camera.gui3d_view(), 64)):
        tape = mpr_tpu_torch.compile_tree(tree)
        depth, normals = render3d(tape, mat=mat, size=size, device="cpu")
        assert (depth > 0).any() and not (depth > 0).all()
        out[name] = (depth, normals)
    return out


def _hold(label, got, want, far):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    d = np.abs(got - want)
    n_out = int((d > CLOSE).sum())
    print(f"{label}: {n_out} of {d.size} pixels outside {CLOSE}, max "
          f"|diff| {d.max():.3g}")
    assert n_out <= (1.0 - SHARE) * d.size, (label, n_out)
    assert d.max() <= far, (label, float(d.max()))


SCENES = ["capped_sphere", "two_spheres"]


def test_sample_tables_equal_bit_for_bit():
    """One generator feeds the hemisphere kernel and then the rotation
    vectors, the static kernel has its own: the port's tables are the JAX
    module's."""
    for name in ("_KERNEL", "_RVECS", "_KERNEL_STATIC"):
        a, b = getattr(effects, name), getattr(jeffects, name)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
    for name in ("RADIUS", "N_SAMPLES", "N_SAMPLES_STATIC", "AMBIENT",
                 "DIFFUSE", "LIGHT_POS", "BLUR_RADIUS"):
        assert getattr(effects, name) == getattr(jeffects, name)


@pytest.mark.parametrize("name", SCENES)
def test_ssao_raw_matches_jax(scenes, name):
    depth, normals = scenes[name]
    _hold(f"raw gather {name}", effects.ssao_raw(depth, normals,
                                                 device="cpu"),
          jeffects.ssao_raw(depth, normals), FAR["gather"])


@pytest.mark.parametrize("name", SCENES)
def test_ssao_raw_static_matches_jax(scenes, name):
    depth, normals = scenes[name]
    _hold(f"raw static {name}",
          effects.ssao_raw_static(depth, normals, device="cpu"),
          jeffects.ssao_raw_static(depth, normals), FAR["static"])


@pytest.mark.parametrize("name", SCENES)
def test_ssao_blur_matches_jax(scenes, name):
    """The blur alone, both packages on the JAX module's raw AO."""
    depth, normals = scenes[name]
    raw = np.asarray(jeffects.ssao_raw(depth, normals))
    _hold(f"blur {name}", effects.ssao_blur(depth, raw, device="cpu"),
          jeffects.ssao_blur(depth, raw), FAR["gather"])


@pytest.mark.parametrize("ao_scale", [1, 2])
@pytest.mark.parametrize("mode", ["static", "gather"])
@pytest.mark.parametrize("name", SCENES)
def test_draw_ssao_matches_jax(scenes, name, mode, ao_scale):
    depth, normals = scenes[name]
    _hold(f"draw_ssao {mode} /{ao_scale} {name}",
          effects.draw_ssao(depth, normals, ao_scale, mode, device="cpu"),
          jeffects.draw_ssao(depth, normals, ao_scale, mode), FAR[mode])


@pytest.mark.parametrize("name", SCENES)
def test_draw_shaded_matches_jax(scenes, name):
    depth, normals = scenes[name]
    _hold(f"shaded {name}", effects.draw_shaded(depth, normals, device="cpu"),
          jeffects.draw_shaded(depth, normals), FAR["shaded"])


@pytest.mark.parametrize("name", SCENES)
def test_shade_alone_matches_jax(scenes, name):
    depth, normals = scenes[name]
    occ = np.asarray(jeffects.draw_ssao(depth, normals))
    got = effects._shade(torch.from_numpy(depth), torch.from_numpy(normals),
                         torch.from_numpy(occ.copy())).numpy()
    want = np.asarray(jeffects._shade(depth, normals, occ))
    assert np.allclose(got, want, rtol=0, atol=1e-6)


def test_config_and_auto_scale(scenes):
    """``mode`` and ``ao_scale`` default to the config; the auto scale is 1
    below 512 in either mode."""
    from mpr_tpu_torch import config
    depth, normals = scenes["two_spheres"]
    assert config.get().ssao_mode == "static" and config.get().ao_scale == 0
    a = effects.draw_ssao(depth, normals, device="cpu")
    assert torch.equal(a, effects.draw_ssao(depth, normals, 1, "static",
                                            device="cpu"))
    with config.override(ssao_mode="gather", ao_scale=2):
        b = effects.draw_ssao(depth, normals, device="cpu")
    assert torch.equal(b, effects.draw_ssao(depth, normals, 2, "gather",
                                            device="cpu"))
    assert not torch.equal(a, b)


# ---- the property tests of tests/test_effects.py, on the port --------------

def test_ssao_range_and_support(scenes):
    depth, normals = scenes["capped_sphere"]
    for mode in ("static", "gather"):
        occ = effects.draw_ssao(depth, normals, mode=mode,
                                device="cpu").numpy()
        assert occ.shape == depth.shape
        m = depth > 0
        assert np.all(occ[~m] == 0.0)
        assert np.all(occ[m] >= 0.0) and np.all(occ[m] <= 1.0)
        # open areas of the cap should be mostly unoccluded
        assert occ[m].mean() > 0.5, mode


def test_ssao_static_agrees_with_gather(scenes):
    """Same support, and occlusion within a small mean absolute difference
    (the sampling patterns differ, so no pointwise equality)."""
    depth, normals = scenes["capped_sphere"]
    a = effects.draw_ssao(depth, normals, mode="static", ao_scale=1,
                          device="cpu").numpy()
    b = effects.draw_ssao(depth, normals, mode="gather", ao_scale=1,
                          device="cpu").numpy()
    m = depth > 0
    assert (a[m] > 0).mean() > 0.95 and (b[m] > 0).mean() > 0.95
    assert np.abs(a[m] - b[m]).mean() < 0.12, np.abs(a[m] - b[m]).mean()


def test_ssao_flat_cap_brighter_than_crease(scenes):
    depth, normals = scenes["capped_sphere"]
    occ = effects.draw_ssao(depth, normals, device="cpu").numpy()
    c = 64
    assert occ[c - 6:c + 6, c - 6:c + 6].mean() > 0.8


def test_shaded_lighting(scenes):
    depth, normals = scenes["capped_sphere"]
    img = effects.draw_shaded(depth, normals, device="cpu").numpy()
    m = depth > 0
    assert np.all(img[~m] == 0.0)
    assert np.all(img[m] >= 0.2 - 1e-6) and np.all(img[m] <= 1.0)
    # light at (5,5,10): the +x+y quadrant of the cap is brighter than -x-y
    q_hi = img[70:90, 70:90][depth[70:90, 70:90] > 0].mean()
    q_lo = img[38:58, 38:58][depth[38:58, 38:58] > 0].mean()
    assert q_hi > q_lo


def test_effects_need_a_device_or_a_card(scenes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    depth, normals = scenes["two_spheres"]
    for fn in (effects.ssao_raw, effects.ssao_raw_static, effects.draw_ssao,
               effects.draw_shaded):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(depth, normals)
    # a tensor brings its device with it
    occ = effects.draw_ssao(torch.from_numpy(depth), normals)
    assert occ.device.type == "cpu"

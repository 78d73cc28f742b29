"""Post-processing effects: SSAO and shaded rendering.

Counterpart of ``mpr_tpu.render.effects`` (functional parity with
``mpr::Effects``, reference/src/effects.cu), as whole-image PyTorch ops on
the device that holds the depth image.  The JAX module has no hand-written
kernel, so none stands behind this one either: gather mode indexes the
depth image with per-pixel sample positions (advanced indexing), static
mode reads shifted slices of a padded depth plane, and no Python loop runs
over pixels (only over the 64 or 128 samples).

Deliberate divergences from the reference (documented per SURVEY.md
section 7), the same as the JAX module's:
  * sample kernels use a fixed NumPy seed instead of C ``rand()``
    (reference/src/effects.cu:225-250), reproducible across runs; the
    tables below are drawn in the JAX module's order and equal it bit for
    bit;
  * normals arrive as float32 vectors rather than round-tripped through
    RGBA8 quantization (:49-53);
  * the edge-aware blur computes window stddev from the window's own
    pixels; the reference indexes stddev samples relative to the image
    ORIGIN (`tx = xmin + i` vs `x + xmin + i`, :131-140), an apparent bug
    fixed rather than replicated.

Rounding: every division by a Python scalar goes through
``transcendental.div_scalar`` and every square root through
``transcendental.sqrt``, so the card and the CPU compute the same image.
AO is a sum of threshold tests, so against the JAX module a last-place
difference can flip a sample and move a pixel by 1/64 (gather) or about
1/count (static), and the blur keeps the window whose deviation is least,
which among flat windows is decided in the last place (XLA at its default
optimisation level contracts ``s2 / c - mean * mean`` into a fused
multiply-add and then keeps another window on a few pixels in ten
thousand); the tests state the tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as _config
from ..ops import transcendental as tc
from ..ops.tape_data import resolve_device

RADIUS = 0.1
N_SAMPLES = 64
AMBIENT = 0.2
DIFFUSE = 0.8
LIGHT_POS = (5.0, 5.0, 10.0)
BLUR_RADIUS = 2

# one generator feeds the hemisphere kernel and then the rotation vectors
_rng = np.random.default_rng(20200716)


def _ssao_kernel() -> np.ndarray:
    """64 hemisphere samples, quadratically scaled toward the center
    (reference/src/effects.cu:231-243)."""
    v = np.stack([_rng.uniform(-1, 1, N_SAMPLES),
                  _rng.uniform(-1, 1, N_SAMPLES),
                  _rng.uniform(0, 1, N_SAMPLES)], axis=1)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    scale = np.arange(N_SAMPLES) / (N_SAMPLES - 1)
    v *= ((scale * scale) * 0.9 + 0.1)[:, None]
    return v.astype(np.float32)


def _ssao_rvecs() -> np.ndarray:
    """16x16 tiled random rotation vectors in the z=0 plane (:244-249)."""
    v = np.stack([_rng.uniform(-1, 1, 256),
                  _rng.uniform(-1, 1, 256),
                  np.zeros(256)], axis=1)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


_KERNEL = _ssao_kernel()
_RVECS = _ssao_rvecs()


def _tensors(depth, normals, device=None):
    """Depth (int32) and normals (f32) as tensors on one device: the
    device of a tensor argument, else ``device`` as the entry points
    resolve it (``cuda``, or an error without a card)."""
    if isinstance(depth, torch.Tensor) and device is None:
        dev = depth.device
    else:
        dev = resolve_device(device)
    def on_dev(a, dtype):
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(np.asarray(a))     # a copy: arrays may be read-only
        return a.to(device=dev, dtype=dtype)
    return on_dev(depth, torch.int32), on_dev(normals, torch.float32)


def _world_pos(depth, size):
    dev = depth.device
    i = torch.arange(size, dtype=torch.float32, device=dev)
    p = 2.0 * (tc.div_scalar(i + 0.5, size) - 0.5)
    px = p[None, :].expand(size, size)
    py = p[:, None].expand(size, size)
    pz = 2.0 * (tc.div_scalar(depth + 0.5, size) - 0.5)
    return px, py, pz


def _occlusion(sz, h, size):
    """One sample's occlusion term: full inside RADIUS of the surface
    below it, a quadratic falloff out to twice RADIUS."""
    actual_z = 2.0 * (tc.div_scalar(h + 0.5, size) - 0.5)
    dz = torch.abs(sz - actual_z)
    below = sz <= actual_z
    near = torch.where(dz < RADIUS, below.to(torch.float32), 0.0)
    fall = tc.div_scalar(RADIUS - (dz - RADIUS), RADIUS)
    far = torch.where((dz >= RADIUS) & (dz < 2 * RADIUS) & below,
                      fall * fall, 0.0)
    return near + far


def ssao_raw(depth, normals, device=None) -> torch.Tensor:
    """Unblurred ambient occlusion in [0,1]; 0 outside the shape
    (draw_ssao, reference/src/effects.cu:17-89)."""
    depth, n = _tensors(depth, normals, device)
    dev = depth.device
    size = depth.shape[0]
    px, py, pz = _world_pos(depth, size)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]

    i = torch.arange(size, device=dev)
    ridx = (i[None, :] % 16) * 16 + (i[:, None] % 16)      # x-major
    rvec = torch.as_tensor(_RVECS, device=dev)[ridx]       # (H, W, 3)
    rx, ry, rz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    ndr = rx * nx + ry * ny + rz * nz
    tx, ty, tz = rx - nx * ndr, ry - ny * ndr, rz - nz * ndr
    tn = torch.clamp_min(tc.sqrt(tx * tx + ty * ty + tz * tz), 1e-12)
    tx, ty, tz = tx / tn, ty / tn, tz / tn
    bx = ny * tz - nz * ty
    by = nz * tx - nx * tz
    bz = nx * ty - ny * tx

    kern = _KERNEL * np.float32(RADIUS)
    occ = torch.zeros(size, size, dtype=torch.float32, device=dev)
    for s in range(N_SAMPLES):
        k0, k1, k2 = (float(v) for v in kern[s])
        sx = tx * k0 + bx * k1 + nx * k2 + px
        sy = ty * k0 + by * k1 + ny * k2 + py
        sz = tz * k0 + bz * k1 + nz * k2 + pz
        ix = ((sx / 2.0 + 0.5) * size).to(torch.int32)
        iy = ((sy / 2.0 + 0.5) * size).to(torch.int32)
        inb = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
        h = torch.where(inb, depth[iy.clamp(0, size - 1).long(),
                                   ix.clamp(0, size - 1).long()], 0)
        occ = occ + _occlusion(sz, h, size)
    out = 1.0 - occ / N_SAMPLES
    return torch.where(depth > 0, out, 0.0)


def _pad2(a, pad: int):
    return torch.nn.functional.pad(a, (pad, pad, pad, pad))


def ssao_blur(depth, raw, device=None) -> torch.Tensor:
    """Edge-aware blur: of the 4 (BLUR_RADIUS+1)² windows touching the
    pixel, keep the mean of the one with the lowest stddev (blur_ssao,
    reference/src/effects.cu:93-156; stddev indexing fixed).  The windows
    are tried x-first, and a tie keeps the earlier one."""
    depth, raw = _tensors(depth, raw, device)
    size = depth.shape[0]
    mask = (depth > 0).to(torch.float32)
    v = raw * mask

    pad = BLUR_RADIUS
    vp, v2p, mp = _pad2(v, pad), _pad2(v * v, pad), _pad2(mask, pad)

    def win_stats(ox, oy):
        # window [ox, ox+BR] x [oy, oy+BR] relative to the pixel
        s = torch.zeros_like(v)
        s2 = torch.zeros_like(v)
        c = torch.zeros_like(v)
        for i in range(BLUR_RADIUS + 1):
            for j in range(BLUR_RADIUS + 1):
                dy, dx = oy + j + pad, ox + i + pad
                s = s + vp[dy:dy + size, dx:dx + size]
                s2 = s2 + v2p[dy:dy + size, dx:dx + size]
                c = c + mp[dy:dy + size, dx:dx + size]
        c1 = torch.clamp_min(c, 1.0)
        mean = s / c1
        var = torch.clamp_min(s2 / c1 - mean * mean, 0.0)
        sd = tc.sqrt(var * c / torch.clamp_min(c - 1.0, 1.0))
        return mean, torch.where(c > 0, sd, float("inf"))

    best_mean = torch.zeros_like(v)
    best_sd = torch.full_like(v, float("inf"))
    for ox in (-BLUR_RADIUS, 0):
        for oy in (-BLUR_RADIUS, 0):
            mean, sd = win_stats(ox, oy)
            take = sd < best_sd
            best_mean = torch.where(take, mean, best_mean)
            best_sd = torch.minimum(sd, best_sd)
    # the reference leaves blurred values on empty pixels and masks at
    # shading time (:175-178); mask here so the SSAO output is clean
    return torch.where((depth > 0) & torch.isfinite(best_sd), best_mean, 0.0)


# ---------------------------------------------------------------------------
# Gather-free SSAO: static screen offsets -> shifted-image reads
# ---------------------------------------------------------------------------
#
# The reference's mechanism rotates a hemisphere kernel into each pixel's
# TBN frame, making every depth lookup a data-dependent 2D index.  The
# static mode removes the per-pixel rotation instead: sample a FIXED set of
# sphere offsets (Mittring-style sphere sampling), mask each sample to the
# normal's hemisphere per pixel via dot(s, n) > 0, and normalize by the
# in-hemisphere count.  Every sample's screen offset is then a constant, so
# the depth lookup is a shifted-image read (one slice of a padded plane)
# and the whole AO pass is elementwise math.  The z test and the two-band
# distance falloff match the gather mode exactly; only the sampling pattern
# differs (documented divergence; the reference's pattern is itself
# arbitrary, rand()-seeded).

N_SAMPLES_STATIC = 128   # sphere samples; about half land in any hemisphere


def _ssao_static_kernel() -> np.ndarray:
    """Fixed sphere sample set, quadratically scaled toward the center
    like the reference's hemisphere kernel (effects.cu:231-243)."""
    rng = np.random.default_rng(20200717)
    n = N_SAMPLES_STATIC
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    scale = np.arange(n) / (n - 1)
    v *= ((scale * scale) * 0.9 + 0.1)[:, None]
    return (v * RADIUS).astype(np.float32)


_KERNEL_STATIC = _ssao_static_kernel()


def ssao_raw_static(depth, normals, device=None) -> torch.Tensor:
    """Gather-free raw AO in [0,1] (see block comment above)."""
    depth, normals = _tensors(depth, normals, device)
    dev = depth.device
    size = depth.shape[0]
    _, _, pz = _world_pos(depth, size)
    kern = _KERNEL_STATIC
    # world -> pixel offset: world spans [-1,1] over `size` pixels
    dxs = np.round(kern[:, 0] / 2.0 * size).astype(int)
    dys = np.round(kern[:, 1] / 2.0 * size).astype(int)
    pad = int(max(np.abs(dxs).max(), np.abs(dys).max(), 1))
    # out-of-image samples read depth 0 (empty), like the gather mode's
    # in-bounds mask
    dp = _pad2(depth, pad)
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]

    occ = torch.zeros(size, size, dtype=torch.float32, device=dev)
    cnt = torch.zeros(size, size, dtype=torch.float32, device=dev)
    for i in range(N_SAMPLES_STATIC):
        kx, ky, kz = (float(kern[i, 0]), float(kern[i, 1]),
                      float(kern[i, 2]))
        dy, dx = int(dys[i]), int(dxs[i])
        # hemisphere mask: sample direction within 90° of the normal
        w = ((nx * kx + ny * ky + nz * kz) > 0.0).to(torch.float32)
        h = dp[pad + dy:pad + dy + size, pad + dx:pad + dx + size]
        occ = occ + _occlusion(pz + kz, h, size) * w
        cnt = cnt + w
    out = 1.0 - occ / torch.clamp_min(cnt, 1.0)
    return torch.where(depth > 0, out, 0.0)


def draw_ssao(depth, normals, ao_scale: int = None, mode: str = None,
              device=None) -> torch.Tensor:
    """Blurred ambient-occlusion image in [0,1] (Effects::drawSSAO), a
    tensor on the device that did the work: the device of a tensor
    ``depth``, else ``device`` (``cuda`` when None, an error without a
    card).

    ``mode`` (default ``config.ssao_mode``): "static" = gather-free
    fixed-offset sampling (see ssao_raw_static), "gather" = the
    reference's per-pixel rotated-hemisphere mechanism (ssao_raw).

    ``ao_scale``: compute the raw AO at 1/ao_scale resolution and
    upsample before the full-resolution edge-aware blur.  Default
    (``config.ao_scale``, 0 = auto): full-res for static mode and <512²
    gather; 2 for gather mode at >=512².  AO is low-frequency and blurred
    anyway, so half-res raw AO + full-res edge-aware blur is visually
    equivalent at a quarter of the lookups (a documented divergence from
    the reference)."""
    cfg = _config.get()
    depth, normals = _tensors(depth, normals, device)
    size = depth.shape[0]
    if mode is None:
        mode = cfg.ssao_mode
    raw_fn = ssao_raw_static if mode == "static" else ssao_raw
    if ao_scale is None:
        ao_scale = cfg.ao_scale
    if ao_scale == 0:
        ao_scale = 2 if (mode == "gather" and size >= 512) else 1
    if ao_scale > 1:
        raw_s = raw_fn(depth[::ao_scale, ::ao_scale].contiguous(),
                       normals[::ao_scale, ::ao_scale].contiguous())
        raw = raw_s.repeat_interleave(ao_scale, 0).repeat_interleave(
            ao_scale, 1)
    else:
        raw = raw_fn(depth, normals)
    return ssao_blur(depth, raw)


def _shade(depth, normals, occ):
    size = depth.shape[0]
    px, py, pz = _world_pos(depth, size)
    lx, ly, lz = LIGHT_POS
    dx, dy, dz = lx - px, ly - py, lz - pz
    inv = torch.div(1.0, tc.sqrt(dx * dx + dy * dy + dz * dz))
    ldn = (dx * normals[..., 0] + dy * normals[..., 1]
           + dz * normals[..., 2]) * inv
    light = torch.clamp_min(ldn, 0.0) * DIFFUSE * occ + AMBIENT
    light = torch.clamp(light, 0.0, 1.0)
    return torch.where(depth > 0, light, 0.0)


def draw_shaded(depth, normals, device=None) -> torch.Tensor:
    """Single-point-light greyscale shading x SSAO + ambient in [0,1]
    (draw_shaded, reference/src/effects.cu:160-221); devices as in
    :func:`draw_ssao`."""
    depth, normals = _tensors(depth, normals, device)
    occ = draw_ssao(depth, normals)
    return _shade(depth, normals, occ)

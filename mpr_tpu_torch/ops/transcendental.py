"""Branch-free f32 asin/acos/atan on torch tensors.

The same Cephes-style polynomial forms (~2 ulp on f32) as
``mpr_tpu.ops.transcendental``, with the same constants in the same order
of operations, so the plain PyTorch kernels, the CUDA kernels
(``csrc/clause.cuh`` repeats them) and the JAX package round alike.
Three torch habits are avoided on purpose: ``scalar / tensor`` multiplies
by the reciprocal (a second rounding), so the division is spelled
``torch.div``; ``torch.sign`` maps NaN to 0, so :func:`sign` keeps NaN and
signed zeros as XLA's sign does; and the vectorised CPU ``torch.sqrt`` of
float32 is not correctly rounded, so :func:`sqrt` is.
"""

from __future__ import annotations

import torch

_PI_2 = 1.5707963267948966
_PI_4 = 0.7853981633974483
_TAN_PI_8 = 0.4142135623730951   # tan(pi/8)
_TAN_3PI_8 = 2.414213562373095   # tan(3pi/8)


def sqrt(x):
    """Correctly rounded float32 square root, as IEEE (and CUDA's sqrtf)
    define it.  On the CPU it rounds the float64 root, which is exact for
    float32 inputs; on CUDA ``torch.sqrt`` already is."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def sign(x):
    """-1, +1, or ``x`` itself for ±0 and NaN."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, x))


def atan(x):
    """f32 arctangent via 3-interval Cephes reduction."""
    a = torch.abs(x)
    big = a > _TAN_3PI_8
    mid = a > _TAN_PI_8
    safe_a = torch.clamp_min(a, 1e-30)
    z = torch.where(big, torch.div(-1.0, safe_a),
                    torch.where(mid, (a - 1.0) / (a + 1.0), a))
    y = torch.where(big, _PI_2, torch.where(mid, _PI_4, 0.0))
    z2 = z * z
    p = ((8.05374449538e-2 * z2 - 1.38776856032e-1) * z2
         + 1.99777106478e-1) * z2 - 3.33329491539e-1
    r = y + z + z * z2 * p
    return sign(x) * r


def asin(x):
    """f32 arcsine; NaN outside [-1, 1] (matches numpy)."""
    a = torch.abs(x)
    over = a > 0.5
    z_hi = 0.5 * (1.0 - a)
    v = torch.where(over, sqrt(torch.clamp_min(z_hi, 0.0)), a)
    z = torch.where(over, z_hi, a * a)
    p = ((((4.2163199048e-2 * z + 2.4181311049e-2) * z
           + 4.5470025998e-2) * z + 7.4953002686e-2) * z
         + 1.6666752422e-1) * z * v + v
    r = torch.where(over, _PI_2 - 2.0 * p, p)
    r = sign(x) * r
    return torch.where(a > 1.0, float("nan"), r)


def acos(x):
    """f32 arccosine; NaN outside [-1, 1]."""
    return _PI_2 - asin(x)

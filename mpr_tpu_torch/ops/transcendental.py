"""Branch-free f32 asin/acos/atan on torch tensors.

The same Cephes-style polynomial forms (~2 ulp on f32) as
``mpr_tpu.ops.transcendental``, with the same constants in the same order
of operations, so the plain PyTorch kernels, the CUDA kernels
(``csrc/clause.cuh`` repeats them) and the JAX package round alike.
Four torch habits are avoided on purpose: ``scalar / tensor`` multiplies
by the reciprocal (a second rounding), so the division is spelled
``torch.div``; on CUDA ``tensor / scalar`` does the same, so
:func:`div_scalar` divides by a tensor; ``torch.sign`` maps NaN to 0, so :func:`sign` keeps NaN and
signed zeros as XLA's sign does; and the vectorised CPU ``torch.sqrt`` of
float32 is not correctly rounded, so :func:`sqrt` is.

Some gradients differ from ``jax.grad``'s, and the plain walks that a fit
differentiates take :func:`abs`, :func:`minimum`, :func:`maximum` and, in
the interpreter, :func:`asin_analytic` (and acos, atan) for them.  The
interpreter's asin/acos/atan are the Cephes forms, where ``mpr_tpu``'s
interpreter takes ``jnp.arcsin`` and its analytic gradient, which the
``*_analytic`` forms give them.  And torch gives ``abs`` the gradient 0 at +-0 and at NaN where JAX gives
1 at +-0 (``x >= 0``) and -1 at NaN, and torch's ``minimum``/``maximum``
pass the whole gradient to both operands where the result is NaN, where
JAX passes none (each side gets 1 where it equals the result, 0.5 at a
tie, 0 otherwise).  Their forward values are torch's own, bit for bit.
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


def div_scalar(x, s: float):
    """``x / s`` as one IEEE division on every device."""
    return x / torch.full_like(x, s)


def sign(x):
    """-1, +1, or ``x`` itself for ±0 and NaN; its gradient is 0, as
    ``jnp.sign``'s."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, x.detach()))


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


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return torch.abs(a)

    @staticmethod
    def backward(ctx, g):
        a, = ctx.saved_tensors
        return torch.where(a >= 0.0, g, -g)


def _balanced(x, y, r):
    """JAX's share of a min/max's gradient for operand ``x``."""
    return torch.where(x == r, torch.where(y == r, 0.5, 1.0), 0.0)


class _MinMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fn):
        r = fn(a, b)
        ctx.save_for_backward(a, b, r)
        return r

    @staticmethod
    def backward(ctx, g):
        a, b, r = ctx.saved_tensors
        return g * _balanced(a, b, r), g * _balanced(b, a, r), None


def _grad_wanted(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in ts)


def abs(x):
    """``torch.abs`` with ``jax.grad``'s gradient (module doc)."""
    return _Abs.apply(x) if _grad_wanted(x) else torch.abs(x)


def minimum(a, b):
    """``torch.minimum`` with ``jax.grad``'s gradient (module doc)."""
    if _grad_wanted(a, b):
        return _MinMax.apply(a, b, torch.minimum)
    return torch.minimum(a, b)


def maximum(a, b):
    """``torch.maximum`` with ``jax.grad``'s gradient (module doc)."""
    if _grad_wanted(a, b):
        return _MinMax.apply(a, b, torch.maximum)
    return torch.maximum(a, b)


class _Analytic(torch.autograd.Function):
    """A Cephes form's value with its function's analytic gradient."""

    @staticmethod
    def forward(ctx, a, fn, grad):
        ctx.save_for_backward(a)
        ctx.grad = grad
        return fn(a)

    @staticmethod
    def backward(ctx, g):
        a, = ctx.saved_tensors
        return ctx.grad(g, a), None, None


def _inv_root(g, a):
    return torch.div(g, sqrt(1.0 - a * a))


def asin_analytic(x):
    """:func:`asin` with ``jnp.arcsin``'s gradient ``1 / sqrt(1 - x^2)``."""
    if not _grad_wanted(x):
        return asin(x)
    return _Analytic.apply(x, asin, _inv_root)


def acos_analytic(x):
    """:func:`acos` with ``jnp.arccos``'s gradient."""
    if not _grad_wanted(x):
        return acos(x)
    return _Analytic.apply(x, acos, lambda g, a: -_inv_root(g, a))


def atan_analytic(x):
    """:func:`atan` with ``jnp.arctan``'s gradient ``1 / (1 + x^2)``."""
    if not _grad_wanted(x):
        return atan(x)
    return _Analytic.apply(x, atan, lambda g, a: torch.div(g, 1.0 + a * a))

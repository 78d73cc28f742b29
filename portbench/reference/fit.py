"""A fit of a scene's constants to a target fill, in plain PyTorch: the
semantics of the port's ``cli fit`` (its scan engine's step), written
again from its description.

The parameters are the scene's constant operands, one for each node that
has one (a compiled tape holds one immediate a clause).  A step renders
the soft fill ``tanh(-sharpness * f) / 2 + 1/2`` at every pixel centre of
the ``size``-square image under the identity view, takes the squared
error against the target summed over the image and divided by its pixels,
and moves every parameter by ``-lr`` times its gradient (plain gradient
descent, the parameters kept in float32).
"""

from __future__ import annotations

import torch

from .evaluate import evaluate, leaf_params
from .render import centers


def fill(e, size: int, dev) -> torch.Tensor:
    """The float32 fill (1 inside) at the pixel centres, identity view: a
    fit's target."""
    c = centers(size, dev)
    f = evaluate(e, c[None, :], c[:, None]).expand(size, size)
    return (f < 0).float()


def steps(e, target, lr: float, n: int, sharpness: float = 20.0,
          dtype=torch.float32, rows: int = None):
    """``n`` steps from the scene's own constants.  Returns (the loss of
    each step, before its update; the parameters after each step, each a
    float32 vector, the first the start).  ``rows`` keeps the first rows of
    the image only, the loss their mean (a fault's reading: half of the
    batch left out)."""
    dev = target.device
    size = target.shape[0]
    rows = size if rows is None else rows
    where, vals = leaf_params(e)
    p = torch.tensor(vals, dtype=torch.float32, device=dev)
    c = centers(size, dev)
    x = c[None, :].expand(rows, size)
    y = c[:rows, None].expand(rows, size)
    target = target[:rows]
    losses, states = [], [p.clone()]
    for _ in range(n):
        leaf = p.detach().requires_grad_(True)
        with torch.enable_grad():
            f = evaluate(e, x, y, None, dtype, params=(where,
                                                       leaf.unbind()))
            soft = torch.tanh(-sharpness * f.float()) * 0.5 + 0.5
            loss = ((soft - target) ** 2).sum() / float(rows * size)
            grad, = torch.autograd.grad(loss, leaf)
        losses.append(float(loss.detach()))
        p = p - lr * grad
        states.append(p.clone())
    return losses, states


def gaps(losses, states, ref_losses, ref_states, lr: float):
    """The three numbers a fit is judged by, each a share of the
    reference's: the worst step's loss gap; the gap between the norms of
    the first gradient as each side's state shows it ((p0 - p1) / lr); the
    gap between the norms of the change after the last step."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))

    def norm_gap(a, b):
        na, nb = float(a.norm()), float(b.norm())
        return abs(na - nb) / nb

    grad = norm_gap((states[0] - states[1]) / lr,
                    (ref_states[0] - ref_states[1]) / lr)
    change = norm_gap(states[-1] - states[0], ref_states[-1] - ref_states[0])
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}

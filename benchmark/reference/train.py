"""The plain supervised SynthSR train step (BBillot/SynthSR ``training.py``
with ``metrics_model.py``), the reference of the train cells.  It imports
nothing of the program.

From a synthetic pair (image (B, X, Y, Z, C), target (B, X, Y, Z, 1)): the
U-Net in train mode on the image, the residual input channel added to its
output, both centre-cropped to ``loss_cropping``, the mean absolute error,
its gradient by autograd, and Adam (optax's: b1 0.9, b2 0.999, eps 1e-8;
no learning-rate decay, the tutorial's) applied only where the loss is
finite.  Float32, TF32 off.
"""

from __future__ import annotations

import torch

from .unet import forward

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def center_crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    begin = [(s - crop) // 2 for s in x.shape[1:-1]]
    return x[(slice(None),) + tuple(slice(b, b + crop) for b in begin)]


def loss_fn(sd, cfg, image, target, loss_cropping, residual, quant=None):
    out = forward(sd, cfg, image.permute(0, 4, 1, 2, 3), train=True, quant=quant)
    pred = out.permute(0, 2, 3, 4, 1) + image[..., list(residual)]
    return (center_crop(pred, loss_cropping) - center_crop(target, loss_cropping)).abs().mean()


def train_steps(sd0: dict, params: list, cfg: dict, pairs, lr: float, loss_cropping: int,
                residual, quant=None, state=None) -> dict:
    """Run one step per (image, target) of ``pairs`` from the weights ``sd0``,
    updating the leaves named in ``params``: {"losses", "grad1" (the first
    step's gradient norm per leaf), "change" (the norm of each leaf's change
    after the last step)}.  ``state``: the Adam state to start from, (first
    moments, second moments, steps taken), each moment a dict by leaf;
    default a fresh one."""
    sd = {k: v.detach().clone().float() for k, v in sd0.items()}
    if state is None:
        mu = {k: torch.zeros_like(sd[k]) for k in params}
        nu = {k: torch.zeros_like(sd[k]) for k in params}
        count = 0
    else:
        mu, nu = ({k: m[k].detach().float() for k in params} for m in state[:2])
        count = int(state[2])
    losses, grad1 = [], None
    for image, target in pairs:
        leaves = {k: sd[k].requires_grad_(True) for k in params}
        loss = loss_fn(sd, cfg, image.float(), target.float(), loss_cropping, residual, quant)
        grads = torch.autograd.grad(loss, [leaves[k] for k in params])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if grad1 is None:
                grad1 = {k: float(g.norm()) for k, g in zip(params, grads)}
            if torch.isfinite(loss):
                count += 1
                c1, c2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
                for k, g in zip(params, grads):
                    mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
                    nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
                    sd[k] = sd[k].detach() - lr * (mu[k] / c1) / (
                        torch.sqrt(nu[k] / c2) + ADAM_EPS)
            for k in params:
                sd[k] = sd[k].detach()
    change = {k: float((sd[k] - sd0[k].float()).norm()) for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}


def leaf_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """|program norm - reference norm| of each leaf, against the larger of
    its reference norm and the median leaf's."""
    norms = sorted(v for k, v in ref.items() if k not in skip)
    median = norms[len(norms) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in ref if k not in skip}


def compare(prog: dict, ref: dict):
    """The numbers a train cell compares: (the relative gap of the first
    step's loss, the median leaf's gap of the first gradient, the worst
    leaf's gap of the change).  The loss is the first step's: a later step
    starts from weights that the earlier updates' rounding already moved,
    and its gap swings with the size of the loss (see PERF.md).  The first
    gradient is taken by its median leaf: its worst leaf is a level-0 conv
    bias whose gradient sums two million near-cancelling terms, so rounding
    alone moves it by up to a third.  Leaves whose first reference gradient
    is under a thousandth of the median leaf's are left out of the change:
    they move by round-off alone."""
    losses = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    grad = sorted(leaf_gaps(prog["grad1"], ref["grad1"]).values())
    g = sorted(ref["grad1"].values())
    tiny = {k for k, v in ref["grad1"].items() if v < 1e-3 * g[len(g) // 2]}
    return (losses, grad[len(grad) // 2],
            max(leaf_gaps(prog["change"], ref["change"], tiny).values()))

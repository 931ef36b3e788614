"""Per-step non-finite loss protection: the port of
``synthsr_tpu/utils/finite_guard.py`` (reference per-batch ``K.check_numerics``,
``SynthSR/metrics_model.py:228``), and the Adam update it gates.

- :func:`guard_updates` is the on-device write gate: new tensors where the
  step's loss is finite, the old ones elsewhere, with no host sync.
- :func:`adam_update` is ``optax.adam`` with the Keras decay schedule
  ``lr / (1 + decay·t)`` (``synthsr_tpu/train/training.py:42-54``) written as a
  functional update, so a non-finite step writes nothing through the gate;
  :func:`gated_adam_step` writes it into the parameters through the gate.
- :class:`FiniteGuard` checks each step's loss ``lag`` steps after it was
  queued, so the host never waits on the step it just launched, and raises
  naming the first non-finite step.
"""

from __future__ import annotations

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam defaults


def guard_updates(finite: torch.Tensor, new, old):
    """``new`` where ``finite`` (a 0-d bool tensor on the device), else
    ``old``, tensor by tensor over two equal lists."""
    return [torch.where(finite, n, o.to(n.dtype)) for n, o in zip(new, old)]


def adam_init(params):
    """Adam state: (step count, first moments, second moments)."""
    zeros = [torch.zeros_like(p) for p in params]
    return {"count": torch.zeros((), dtype=torch.int64, device=params[0].device),
            "mu": zeros, "nu": [torch.zeros_like(p) for p in params]}


def adam_update(params, grads, state, lr: float, lr_decay: float = 0.0):
    """One Adam step as optax computes it: (new params, new state).  The
    learning rate of step t (counted from 0) is ``lr / (1 + lr_decay·t)``;
    the bias corrections use t + 1."""
    count = state["count"] + 1
    t = count.to(torch.float32)
    step_lr = lr / (1.0 + lr_decay * (t - 1.0))
    mu = [ADAM_B1 * m + (1.0 - ADAM_B1) * g for m, g in zip(state["mu"], grads)]
    nu = [ADAM_B2 * v + (1.0 - ADAM_B2) * g * g for v, g in zip(state["nu"], grads)]
    c1, c2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
    new = [p - step_lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
           for p, m, v in zip(params, mu, nu)]
    return new, {"count": count, "mu": mu, "nu": nu}


def gated_adam_step(params, grads, state, finite: torch.Tensor, lr: float,
                    lr_decay: float = 0.0):
    """One :func:`adam_update`, copied into ``params`` in place where
    ``finite``; returns the Adam state to carry on with (the old one where
    not finite).  Call under ``torch.no_grad()``."""
    new_params, new = adam_update(params, grads, state, lr, lr_decay)
    for p, n in zip(params, guard_updates(finite, new_params, params)):
        p.copy_(n)
    return {"count": guard_updates(finite, [new["count"]], [state["count"]])[0],
            "mu": guard_updates(finite, new["mu"], state["mu"]),
            "nu": guard_updates(finite, new["nu"], state["nu"])}


class FiniteGuard:
    """Lagged per-step host check: ``push`` every step's (label, loss); the
    value pushed ``lag`` pushes ago is read and verified; ``flush()`` drains
    the rest at the end of an epoch.  Raises ``FloatingPointError`` naming the
    step that produced the first non-finite value."""

    def __init__(self, lag: int = 2, what: str = "loss"):
        self.lag = max(0, int(lag))
        self.what = what
        self._pending = []

    def _check(self, label, value) -> float:
        v = float(value)
        if not np.isfinite(v):
            raise FloatingPointError(f"Non-finite {self.what} at {label}: {v} "
                                     "(parameters were not updated by this step)")
        return v

    def push(self, label, value) -> None:
        self._pending.append((label, value))
        if len(self._pending) > self.lag:
            self._check(*self._pending.pop(0))

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        for label, value in pending:
            self._check(label, value)

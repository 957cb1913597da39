"""Adam with the non-finite-gradient step guard, written on tensors.

Counterpart of ``perf_tpu/core/optim.py:36-67`` (``all_finite``,
``guarded_step``) together with the optimizer the scene builds around it
(``perf_tpu/train/scene.py:133-134, 460-465``): optax ``scale_by_adam``
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments) and the update
``p - lr * m_hat / (sqrt(v_hat) + eps)``.

The guard is GradScaler's skip: when any gradient is NaN or infinite the
step does not happen, so the parameters, both moments and the step count
keep their old values. The verdict stays on the device and every commit is
a ``torch.where`` over it: a step never waits for the host.
"""

from __future__ import annotations

import torch


def all_finite(tensors) -> torch.Tensor:
    """0-dim bool tensor: every element of every tensor is finite."""
    ok = None
    for t in tensors:
        f = torch.isfinite(t).all()
        ok = f if ok is None else ok & f
    return ok


class GuardedAdam:
    """Adam state for a list of parameter tensors, updated in place."""

    def __init__(self, params: list, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=params[0].device)

    def step(self, params: list, grads: list, lr: float,
             finite: torch.Tensor | None = None) -> torch.Tensor:
        """Commit ``p - lr * adam(g)`` for every parameter iff all gradients
        are finite (or iff ``finite``, a verdict over a larger set of
        gradients); returns the 0-dim bool verdict."""
        if finite is None:
            finite = all_finite(grads)
        count = self.count + 1
        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, c)
        bc2 = 1.0 - torch.pow(self.b2, c)
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m_new = (1.0 - self.b1) * g + self.b1 * m
            v_new = (1.0 - self.b2) * (g * g) + self.b2 * v
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            p.copy_(torch.where(finite, p - lr * u, p))
            m.copy_(torch.where(finite, m_new, m))
            v.copy_(torch.where(finite, v_new, v))
        self.count = torch.where(finite, count, self.count)
        return finite

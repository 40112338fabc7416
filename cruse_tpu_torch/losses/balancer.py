"""Gradient-norm loss balancer (counterpart of ``cruse_tpu/losses/balancer.py``).

The train step runs the model once to its output, computes every loss from
the output alone, takes one ``torch.autograd.grad`` per loss with respect to
the output (the model is not traversed), averages each gradient's norm with
an exponential moving average, rescales each gradient to
``ratio_k * total_norm / avg_norm_k``, and sums them into one cotangent that
a single backward through the model carries to the parameters.

The state (the average's numerator and denominator per loss) is explicit and
carried in the train state; nothing here is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass
class BalancerState:
    """Moving-average accumulators by loss name (0-d tensors)."""

    total: Dict[str, torch.Tensor]
    fix: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Balancer:
    """Weights and hyperparameters; the methods are pure functions."""

    weights: Tuple[Tuple[str, float], ...]  # ordered (name, weight)
    rescale_grads: bool = True
    total_norm: float = 1.0
    ema_decay: float = 0.999
    per_batch_item: bool = True
    epsilon: float = 1e-12

    @staticmethod
    def make(weights: Dict[str, float], **kw) -> "Balancer":
        return Balancer(weights=tuple(sorted(weights.items())), **kw)

    def init_state(self, device=None) -> BalancerState:
        names = [k for k, _ in self.weights]
        return BalancerState(total={k: torch.zeros((), device=device) for k in names},
                             fix={k: torch.zeros((), device=device) for k in names})

    def output_cotangent(self, loss_fns: Dict[str, Callable[[torch.Tensor], torch.Tensor]],
                         output: torch.Tensor, state: BalancerState):
        """The combined cotangent with respect to the model's ``output``.

        Returns ``(out_grad, losses, new_state, metrics)``; ``out_grad`` goes
        into the model's backward. ``output`` is taken as a constant here."""
        names = [k for k, _ in self.weights]
        w = dict(self.weights)
        out = output.detach().requires_grad_(True)
        grads, losses, norms = {}, {}, {}
        with torch.enable_grad():
            for name in names:
                loss = loss_fns[name](out)
                (grad,) = torch.autograd.grad(loss, out)
                losses[name], grads[name] = loss.detach(), grad
                if self.per_batch_item:
                    norms[name] = grad.reshape(grad.shape[0], -1).square().sum(dim=1).sqrt().mean()
                else:
                    norms[name] = grad.square().sum().sqrt()

        new_total = {k: state.total[k] * self.ema_decay + norms[k] for k in names}
        new_fix = {k: state.fix[k] * self.ema_decay + 1.0 for k in names}
        total_weight = sum(w[k] for k in names)
        out_grad = torch.zeros_like(out)
        for name in names:
            if self.rescale_grads:
                avg_norm = new_total[name] / new_fix[name]
                scale = (w[name] / total_weight) * self.total_norm / (self.epsilon + avg_norm)
            else:
                scale = w[name]
            out_grad = out_grad + scale * grads[name]
        metrics = {f"loss_{k}": losses[k] for k in names}
        return out_grad, losses, BalancerState(new_total, new_fix), metrics

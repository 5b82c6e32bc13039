"""Train state: the model's parameters, clip-by-global-norm then AdamW on a
warmup-cosine schedule, and an optional EMA of the parameters.

Counterpart of `hybrid_diffusion_tpu/train/train_state.py`, with optax's
arithmetic:

  - the clip is optax's `clip_by_global_norm`: when the global norm ‖g‖ is
    at least max_norm every gradient becomes (g / ‖g‖)·max_norm; there is
    no 1e-6 in the denominator (`torch.nn.utils.clip_grad_norm_` has one);
  - AdamW (β 0.9, 0.999, ε 1e-8 outside the square root, decoupled decay
    on every parameter) is `torch.optim.AdamW`, its learning rate set from
    the schedule at the count of updates before this one, as optax's
    `scale_by_schedule` reads it;
  - EMA is e·d + p·(1 − d), updated by the step after its domain-gate
    blend.

The state updates the model's parameters in place (the JAX state is
immutable and donated). `grad_accum` > 1 (optax.MultiSteps) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .schedule import warmup_cosine_schedule


class TrainState:
    """Parameters (by name, those of `model`), optimizer, schedule, EMA."""

    def __init__(self, model: torch.nn.Module, *, lr: float = 5e-5,
                 weight_decay: float = 1e-4, grad_clip: float = 1.0,
                 total_epochs: int = 1000, steps_per_epoch: int = 100,
                 multiplier: float = 2.0, warm_epochs: Optional[int] = None,
                 ema_decay: float = 0.0, grad_accum: int = 1):
        if grad_accum > 1:
            raise NotImplementedError(
                "grad_accum > 1 (optax.MultiSteps) is not ported yet "
                "(ROADMAP.md, queue 1, item 6)")
        self.model = model
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        self.schedule = warmup_cosine_schedule(lr, total_epochs,
                                               steps_per_epoch, multiplier,
                                               warm_epochs)
        self.grad_clip = grad_clip
        self.optimizer = torch.optim.AdamW(
            list(self.params.values()), lr=self.schedule(0),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.step = 0
        self.ema_decay = ema_decay
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in self.params.items()}
            if ema_decay > 0 else None)

    def moments(self, name: str) -> Dict[str, torch.Tensor]:
        """AdamW's exp_avg and exp_avg_sq of one parameter (zeros before
        the first update, as optax's initial state)."""
        p = self.params[name]
        st = self.optimizer.state.get(p)
        if not st:
            return {"exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
        return {"exp_avg": st["exp_avg"], "exp_avg_sq": st["exp_avg_sq"]}

    def grads(self) -> list[torch.Tensor]:
        """Every parameter's gradient; zeros where backward left none."""
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params.values()]

    def clip_by_global_norm(self) -> torch.Tensor:
        """optax's clip, in place on the gradients; returns their global
        norm before the clip (a device scalar, no host sync)."""
        grads = self.grads()
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        keep = g_norm < self.grad_clip
        one = torch.ones_like(g_norm)
        torch._foreach_div_(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one,
                                               one * self.grad_clip))
        return g_norm

    def apply_gradients(self) -> torch.Tensor:
        """Clip, then one AdamW update at schedule(step). Returns the
        gradients' global norm before the clip."""
        g_norm = self.clip_by_global_norm()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return g_norm

    @torch.no_grad()
    def update_ema(self) -> None:
        """ema ← d·ema + (1 − d)·params; nothing without EMA."""
        if self.ema_params is None:
            return
        d = self.ema_decay
        ema = list(self.ema_params.values())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(
            [p.detach() for p in self.params.values()], 1.0 - d))

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The parameters to sample with: EMA when kept, else the live ones."""
        if self.ema_params is None:
            return {n: p.detach() for n, p in self.params.items()}
        return self.ema_params


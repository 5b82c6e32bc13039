"""The diffusion training step.

Counterpart of `hybrid_diffusion_tpu/train/step.py`:

    uint8 batch → normalize → t ~ U[0, T), ε ~ N(0, 1) → q-sample → U-Net
    ε-prediction (train mode: dropout) → x₀ → composite loss → backward →
    domain-gated middle-block grads → clip + AdamW → blend the gated
    blocks' parameters and AdamW moments back → EMA.

The step is the span "train/step" and its phases are its child spans
("train/forward", "train/loss", "train/backward", "train/gates",
"train/update"; utils/profiling.py::span, each with the card's time),
which record only inside a profiler (profile_train.py prints them, the
benchmark's traced run reads the loss and update spans).

Every random draw (t, ε, the p_uncond drop, the dropout masks) comes from
the caller's `torch.Generator`, in that order; the global generator is never
used. For parity tests the step also takes `t` and `noise`, which replace
the first two draws.

On a mesh (`mesh`, parallel/sharding.py::make_sharded_train_step) each rank
passes its rows of the global batch. t, ε and the p_uncond drop are drawn
for the global batch from the generator, which is in the same state on
every rank, and each rank keeps its rows (as JAX draws them from one key);
a given `t` or `noise` covers the global batch. The dropout masks come
from a generator of the rank's own (equal across "model", where the
activations are replicated), seeded from the run's seed, the data rank and
the micro-step. The loss's global-batch statistics are summed over "data"
(losses/composite.py, models/unet.py), DDP averages the gradients, and the
metrics are averaged over "data". One rank calls no collective.

Freezing a gated block needs more than a zero gradient: AdamW's decay and
its moments' decay would still move it. As the JAX step does, the blend
puts the block's parameters and moments back to their values before the
update. AdamW's per-parameter step count stays advanced: optax keeps one
count for every parameter, which the JAX blend never touches, and a
restored count would give the block other bias corrections than optax's
when it opens again.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..diffusion.process import predict_x0_from_eps, q_sample
from ..diffusion.schedule import DiffusionSchedule
from ..losses.composite import CompositeLossConfig, composite_enhancement_loss
from ..models.unet import NUM_MIDDLE_BLOCKS, domain_gates_from_batch
from ..parallel.collectives import all_reduce_
from ..parallel.mesh import axis_group, axis_rank, axis_size
from ..utils.precision import precision_for
from ..utils.profiling import span
from .train_state import TrainState


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1], on x's device (so the copy to the
    card moves 1 byte a pixel)."""
    return x.to(torch.float32) / 255.0 * 2.0 - 1.0


def dropout_seed(generator: torch.Generator, data_rank: int,
                 counter: int) -> int:
    """The seed of a data rank's dropout generator at micro-step `counter`:
    a function of the run's generator seed, the rank and the step, so a
    resumed run draws the masks an uninterrupted one draws."""
    mix = np.random.SeedSequence([generator.initial_seed() % 2**63,
                                  data_rank, counter])
    return int(mix.generate_state(1, np.uint64)[0] % 2**63)


def middle_block(name: str) -> Optional[int]:
    """i when the parameter `name` lies under middle_i, else None."""
    head = name.split(".", 1)[0]
    if head.startswith("middle_"):
        i = int(head[len("middle_"):])
        if i < NUM_MIDDLE_BLOCKS:
            return i
    return None


def apply_domain_gates(params: Mapping[str, torch.nn.Parameter],
                       gates: torch.Tensor) -> None:
    """Scale each middle_i parameter's gradient by gates[i], in place (before
    the clip, so a gated block adds nothing to the global norm)."""
    for name, p in params.items():
        i = middle_block(name)
        if i is not None and p.grad is not None:
            p.grad.mul_(gates[i])


@torch.no_grad()
def blend_by_gates(new: Mapping[str, torch.Tensor],
                   old: Mapping[str, torch.Tensor],
                   gates: torch.Tensor) -> None:
    """For each middle_i tensor of `new` (keyed by parameter name), keep it
    where gates[i] is open, else put back `old`'s: in place, the JAX step's
    new·g + old·(1−g) for g in {0, 1}."""
    for name, tensor in new.items():
        i = middle_block(name)
        if i is not None:
            tensor.copy_(torch.where(gates[i] > 0, tensor, old[name]))


def _gated_snapshot(state: TrainState) -> dict[str, dict[str, torch.Tensor]]:
    """Copies of the middle blocks' parameters and AdamW moments."""
    snap: dict[str, dict[str, torch.Tensor]] = {
        "param": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in state.params.items():
        if middle_block(name) is not None:
            snap["param"][name] = p.detach().clone()
            for key, m in state.moments(name).items():
                snap[key][name] = m.clone()
    return snap


def diffusion_train_step(
    state: TrainState,
    batch: Mapping[str, torch.Tensor],
    generator: torch.Generator,
    schedule: DiffusionSchedule,
    loss_config: CompositeLossConfig = CompositeLossConfig(),
    dino_loss_fn: Optional[Callable] = None,
    use_conditioning: bool = False,
    p_uncond: float = 0.02,
    domain_routing: bool = True,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    vgg_loss_fn: Optional[Callable] = None,
    mesh=None,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimization step, in place on `state`.

    batch: {"input": degraded (B, H, W, 3) uint8, "gt": clean (B, H, W, 3)
    uint8}, tensors on any device or numpy arrays; the step runs on the
    model's device. `generator` lies on
    that device. Returns (state, metrics): the loss terms, "total",
    "grad_norm" (of the gated grads, before the clip) and, with domain
    routing, "underwater_gate"; device scalars.
    """
    with span("train/step", device=True):
        device = next(iter(state.params.values())).device
        input_img = normalize_uint8(torch.as_tensor(batch["input"]).to(device))
        gt = normalize_uint8(torch.as_tensor(batch["gt"]).to(device))
        B = gt.shape[0]
        # This rank's rows of the global batch of B·D.
        D, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
        data_group = axis_group(mesh, "data")
        rows = slice(d * B, (d + 1) * B)

        if t is None:
            t = torch.randint(0, schedule.num_steps, (B * D,), device=device,
                              generator=generator)
        t = t[rows].to(device)
        if noise is None:
            noise = torch.randn((B * D,) + tuple(gt.shape[1:]), device=device,
                                generator=generator)
        noise = noise[rows].to(device)
        y_t = q_sample(schedule, gt, t, noise)
        x6 = torch.cat([input_img, y_t], dim=-1)
        if use_conditioning:
            context_zero = torch.rand((B * D,), device=device,
                                      generator=generator)[rows] < p_uncond
        else:
            context_zero = True
        aux_w = (torch.as_tensor(schedule.alphas_bar, device=device)[t.long()]
                 if loss_config.aux_snr_weight else None)
        drop_gen = generator
        if D > 1:
            drop_gen = torch.Generator(device).manual_seed(dropout_seed(
                generator, d, state.step * state.grad_accum + state.mini_step))

        state.optimizer.zero_grad(set_to_none=True)
        with span("train/forward", device=True):
            noise_pred = state.train_model(x6, t, cond_image=input_img,
                                           context_zero=context_zero,
                                           train=True, generator=drop_gen)
        with span("train/loss", device=True):
            x0_pred = predict_x0_from_eps(schedule, y_t, t, noise_pred)
            loss, parts = composite_enhancement_loss(
                noise_pred, noise, x0_pred, gt, loss_config,
                dino_loss_fn=dino_loss_fn, vgg_loss_fn=vgg_loss_fn,
                aux_weights=aux_w, group=data_group)
        with span("train/backward", device=True):
            loss.backward()

        gates = None
        if domain_routing:
            with span("train/gates", device=True):
                gates = domain_gates_from_batch(input_img, group=data_group)
        with span("train/update", device=True):
            parts["grad_norm"] = gated_update(state, gates)
        if gates is not None:
            parts["underwater_gate"] = gates[0]
        metrics = {k: v.detach() for k, v in parts.items()}
        if data_group is not None:   # the global batch's: the mean over "data"
            values = all_reduce_(torch.stack(list(metrics.values())).float(),
                                 data_group) / D
            metrics = dict(zip(metrics, values.unbind()))
        return state, metrics


def gated_update(state: TrainState,
                 gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's update from the gradients that backward left: with
    `gates`, the middle blocks' gradients gated, then clip + AdamW, then
    the gated blocks' parameters and moments blended back; then the EMA.
    With grad_accum k > 1 the gradients first enter the running mean, and
    the update runs on the mean at every k-th call (a block gated off at a
    call keeps its running mean, as the JAX blend of MultiSteps' state
    does). Returns the global norm of this call's (gated) gradients."""
    closed = None
    if gates is not None:
        apply_domain_gates(state.params, gates)
        closed = {n: gates[middle_block(n)] <= 0 for n in state.params
                  if middle_block(n) is not None}
    if state.grad_accum > 1:
        grad_norm = state.global_norm()
        if not state.accumulate(closed):
            return grad_norm
    if gates is not None:
        before = _gated_snapshot(state)
    clipped_norm = state.apply_gradients()
    if gates is not None:
        blend_by_gates(state.params, before["param"], gates)
        for key in ("exp_avg", "exp_avg_sq"):
            blend_by_gates({n: state.moments(n)[key] for n in before[key]},
                           before[key], gates)
    if state.grad_accum == 1:
        grad_norm = clipped_norm
    state.update_ema()
    return grad_norm


def make_train_step(
    schedule: DiffusionSchedule,
    loss_config: CompositeLossConfig = CompositeLossConfig(),
    dino_loss_fn: Optional[Callable] = None,
    use_conditioning: bool = False,
    p_uncond: float = 0.02,
    domain_routing: bool = True,
    vgg_loss_fn: Optional[Callable] = None,
    mesh=None,
) -> Callable:
    """step(state, batch, generator, t=None, noise=None) -> (state,
    metrics), closed over the static configuration (and the mesh, None for
    one process). The schedule's tables
    are copied to the model's device on the first call (a copy from the
    host at every step would wait for the card). An fp32 model's step runs
    with TF32 off (utils/precision.py)."""
    tables = None

    def step(state, batch, generator, t=None, noise=None):
        nonlocal tables
        if tables is None:
            device = next(iter(state.params.values())).device
            tables = DiffusionSchedule(**{
                f.name: torch.as_tensor(getattr(schedule, f.name),
                                        device=device)
                for f in dataclasses.fields(schedule)})
        with precision_for(state.model.dtype != torch.float32):
            return diffusion_train_step(
                state, batch, generator, tables, loss_config, dino_loss_fn,
                use_conditioning, p_uncond, domain_routing, t=t, noise=noise,
                vgg_loss_fn=vgg_loss_fn, mesh=mesh)

    return step

"""The check catches a broken timed path: each cell's run, at a tiny size
on the CPU (the look for a card skipped), with a fault planted in the
program underneath, comes out not correct; the same run unbroken comes
out correct.

Faults, as a cell can have them: a step that returns its state unchanged;
half of the batch left out (the loss's mean taken over the rest); an
answer altered where it is produced. (One card: no exchange between
chips to leave out.) Training has more that its `why` names: the
attention's backward returning a wrong dK, the gradient scaled, the domain
gates left open or inverted, and an update that stops only once the
window has begun.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny

ENHANCE = "flagship256-enhance-b8"
SAMPLE = "cfg-cifar10-sample-w1.8"
TRAIN = "flagship256-train-b16"


def _correct(name, tmp_path) -> bool:
    line, rc = bench_run.run_cell(tiny.run(name, tmp_path))
    assert rc == 0
    return line["correct"]


# -- faults planted in the program, by cell ---------------------------------

def _sampler_no_steps(mp):
    """DPM-Solver++(2M) returns its initial state: no step moves it."""
    from hybrid_diffusion_tpu_torch.diffusion.sampler import initial_noise
    from hybrid_diffusion_tpu_torch.train import loop

    def frozen(denoise, schedule, cond, generator=None, steps=20,
               guidance_scale=1.0, init_noise=None):
        x = initial_noise(cond, generator) if init_noise is None else init_noise
        return x.clamp(-1.0, 1.0)
    mp.setattr(loop, "dpm_solver_pp_2m_sample", frozen)


def _enhancer_half_batch(mp):
    """Each device call computes the first half of its batch and returns
    it for the second half too."""
    from hybrid_diffusion_tpu_torch.serve import Enhancer

    real = Enhancer._run

    def half(self, batch_u8):
        out = real(self, batch_u8)
        h = (len(out) + 1) // 2
        out[h:] = out[:len(out) - h]
        return out
    mp.setattr(Enhancer, "_run", half)


def _enhancer_altered_answer(mp):
    """One image of each reply comes back altered (its colours inverted)."""
    from hybrid_diffusion_tpu_torch.serve import Enhancer

    real = Enhancer.enhance

    def altered(self, images):
        out = real(self, images)
        out[-1] = 255 - out[-1]
        return out
    mp.setattr(Enhancer, "enhance", altered)


def _ddpm_step_unchanged(mp):
    from hybrid_diffusion_tpu_torch.cfg import sampler

    mp.setattr(sampler, "ddpm_step", lambda schedule, x, t, eps, z: x)


def _guided_half_batch(mp):
    """The guided ε of the first half of the rows, given to all of them."""
    from hybrid_diffusion_tpu_torch.cfg import sampler

    real = sampler._guided_eps

    def half(denoise_fn, x_t, t, labels, w):
        h = (x_t.shape[0] + 1) // 2
        eps = real(denoise_fn, x_t[:h], t[:h], labels[:h], w)
        return torch.cat([eps, eps])[: x_t.shape[0]]
    mp.setattr(sampler, "_guided_eps", half)


def _chain_altered_answer(mp):
    """The chain's output comes back with one image altered."""
    from hybrid_diffusion_tpu_torch.cfg import sampler

    real = sampler.cfg_ddpm_sample

    def altered(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[-1] = -out[-1]
        return out
    mp.setattr(sampler, "cfg_ddpm_sample", altered)


def _update_skipped(mp):
    """The optimizer's update leaves the parameters as they were."""
    from hybrid_diffusion_tpu_torch.train.train_state import TrainState

    mp.setattr(TrainState, "apply_gradients",
               lambda self: self.clip_by_global_norm())


def _train_half_batch(mp):
    """The step trains on the first half of each batch."""
    from hybrid_diffusion_tpu_torch.train import step

    real = step.diffusion_train_step

    def half(state, batch, *args, **kwargs):
        b = batch["gt"].shape[0] // 2
        return real(state, {k: v[:b] for k, v in batch.items()}, *args,
                    **kwargs)
    mp.setattr(step, "diffusion_train_step", half)


def _attention_dk_doubled(mp):
    """The attention's backward hands back dK twice over."""
    from hybrid_diffusion_tpu_torch.models import blocks

    real = blocks.fused_spatial_attention

    class Doubled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, k):
            return k.view_as(k)

        @staticmethod
        def backward(ctx, grad):
            return 2 * grad

    mp.setattr(blocks, "fused_spatial_attention",
               lambda q, k, v: real(q, Doubled.apply(k), v))


def _gradient_doubled(mp):
    """Every gradient of the U-Net twice over (its output's, doubled)."""
    from hybrid_diffusion_tpu_torch.models.unet import DynamicUNet

    real = DynamicUNet.forward

    def doubled(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if out.requires_grad:
            out.register_hook(lambda g: 2 * g)
        return out
    mp.setattr(DynamicUNet, "forward", doubled)


def _gates(mp, change):
    from hybrid_diffusion_tpu_torch.train import step

    real = step.domain_gates_from_batch
    mp.setattr(step, "domain_gates_from_batch",
               lambda *a, **k: change(real(*a, **k)))


def _gates_open(mp):
    """Every middle block trains on every batch."""
    _gates(mp, torch.ones_like)


def _gates_inverted(mp):
    """The other domain's middle blocks train."""
    _gates(mp, lambda g: 1.0 - g)


def _update_skipped_in_window(mp):
    """The update stops once set-up's steps are done: only the window's
    steps leave the parameters as they were."""
    from benchmark import trainrun
    from hybrid_diffusion_tpu_torch.train.train_state import TrainState

    real = TrainState.apply_gradients

    def late(self):
        if self.step < trainrun.FIRST_STEPS:
            return real(self)
        return self.clip_by_global_norm()
    mp.setattr(TrainState, "apply_gradients", late)


def _altered_row(model_class):
    """The model's ε for one row of each batch is altered where it is
    produced (+0.5 on the last row)."""
    real = model_class.forward

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs).clone()
        out[-1] = out[-1] + 0.5
        return out
    return altered


def _unet_answer_altered(mp):
    from hybrid_diffusion_tpu_torch.models.unet import DynamicUNet

    mp.setattr(DynamicUNet, "forward", _altered_row(DynamicUNet))


FAULTS = [
    (ENHANCE, _sampler_no_steps), (ENHANCE, _enhancer_half_batch),
    (ENHANCE, _enhancer_altered_answer),
    (SAMPLE, _ddpm_step_unchanged), (SAMPLE, _guided_half_batch),
    (SAMPLE, _chain_altered_answer),
    (TRAIN, _update_skipped), (TRAIN, _train_half_batch),
    (TRAIN, _unet_answer_altered), (TRAIN, _attention_dk_doubled),
    (TRAIN, _gradient_doubled), (TRAIN, _gates_open),
    (TRAIN, _gates_inverted), (TRAIN, _update_skipped_in_window),
]


@pytest.mark.parametrize("name", [ENHANCE, SAMPLE, TRAIN])
def test_sound_run_is_correct(name, tmp_path):
    assert _correct(name, tmp_path)


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_fault_is_caught(name, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    assert not _correct(name, tmp_path)

"""The port's training loop, CLI and gradient accumulation (CPU, tiny
config), mirroring tests/test_train.py's behaviours of the JAX loop.

Tolerances:
  - grad_accum 2 over two micro-batches against one step on the batch of
    both (fixed t and noise, dropout 0, mean losses): AdamW's moments
    within 1e-5 of the largest moment of their kind in the model (the
    gradient's mean summed in another order), the parameters
    and the EMA within 4 ulps where the gradient is at least 1e-4 of its
    largest (AdamW's first step, lr·g/(|g| + ε), flips with the sign of a
    gradient at the rounding level);
  - grad_accum 2 against optax.MultiSteps(clip, adamw) with the JAX step's
    gate and blend, fed the same gradients and gates (the same bounds as
    tests/test_torch_optim.py: moments rel ≤ 1e-5, parameters within 1e-5
    of their change plus 4 ulps a micro-step);
  - the exported npz loads in the JAX package's `load_params_npz` to the
    exported weights' fp16 values, exactly.
Everything else is control flow and compared exactly.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, rel_err  # noqa: F401
from hybrid_diffusion_tpu.train.step import (
    apply_domain_gates as jax_apply_gates,
    blend_by_gates as jax_blend,
)
from hybrid_diffusion_tpu.train.train_state import (
    create_train_state as jax_create_state,
)
from hybrid_diffusion_tpu.utils.params_io import flatten_params as jax_flatten
from hybrid_diffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from hybrid_diffusion_tpu_torch import cli
from hybrid_diffusion_tpu_torch.config import Config, parse_config
from hybrid_diffusion_tpu_torch.data.registry import load_image
from hybrid_diffusion_tpu_torch.train import checkpoint as tck
from hybrid_diffusion_tpu_torch.train import loop
from hybrid_diffusion_tpu_torch.train.step import gated_update
from hybrid_diffusion_tpu_torch.train.train_state import TrainState
from hybrid_diffusion_tpu_torch.utils import precision
from hybrid_diffusion_tpu_torch.weights import save_npz_state_dict
from test_torch_optim import HYPER, Toy, toy_tree

BASE = dict(synthetic_data=True, synthetic_length=8, batch_size=8,
            img_size=16, channel=32, channel_mult=(1, 2), num_res_blocks=1,
            T=8, save_checkpoint=10_000, dino_weight=0.0, bf16=False,
            ms_ssim_weight=0.0, color_weight=0.0, num_workers=1,
            device="cpu")


def cfg(tmp_path, **kw):
    return Config(**{**BASE, "checkpoint_dir": str(tmp_path / "ck"),
                     "output_path": str(tmp_path / "o"), **kw})


def test_staged_budget_then_stage_aware_resumes(tmp_path, capsys):
    """A staged run stopped by its budget inside stage 2 resumes INTO stage
    2 (full state); a stage-1 final checkpoint resumes at stage 2 with a
    fresh optimizer; every model parameter stays on the run's device."""
    s1 = loop.train(cfg(tmp_path, epochs_stage_1=1, epochs_stage_2=2000),
                    max_steps=3)
    assert s1["steps"] == 3
    assert "Underwater" in s1["stages"][-1]["checkpoint"]
    assert [s["stage"] for s in s1["stages"]] == ["Atmospheric", "Underwater"]
    assert all(p.device.type == "cpu" for p in s1["model"].parameters())
    capsys.readouterr()
    s2 = loop.train(cfg(tmp_path, epochs_stage_1=1, epochs_stage_2=2000,
                        resume_from="auto"), max_steps=5)
    out = capsys.readouterr().out
    assert "skipping completed stage Atmospheric" in out
    assert "resumed full state" in out
    assert [s["stage"] for s in s2["stages"]] == ["Underwater"]
    assert s2["steps"] == 5

    other = tmp_path / "b"
    first = loop.train(cfg(other, epochs_stage_1=2, epochs_stage_2=0))
    ck = first["stages"][-1]["checkpoint"]
    assert "_final_" in ck and "Atmospheric" in ck
    assert first["steps"] == 2
    capsys.readouterr()
    second = loop.train(cfg(other, epochs_stage_1=2, epochs_stage_2=1,
                            resume_from=ck))
    out = capsys.readouterr().out
    assert [s["stage"] for s in second["stages"]] == ["Underwater"]
    assert "skipping completed stage Atmospheric" in out
    assert "fresh optimizer" in out
    assert second["state"].step == 1 and second["steps"] == 3


def test_resume_auto_falls_back_to_npz_warm_start(tmp_path, capsys):
    c = cfg(tmp_path, epochs_stage_1=1, epochs_stage_2=0, save_checkpoint=1,
            resume_from="auto", init_from_npz=str(tmp_path / "w.npz"),
            lr=1e-5)
    model = loop.init_params(Config(**{**c.__dict__, "init_from_npz": "",
                                       "seed": 3}), "cpu")
    save_npz_state_dict(str(tmp_path / "w.npz"), model.state_dict())
    summary = loop.train(c, max_steps=1)
    out = capsys.readouterr().out
    assert "falling back to the --init_from_npz warm-start" in out
    assert "warm-start params from" in out
    assert "WARNING" not in out
    meta = tck.load_metadata(tck.find_latest_checkpoint(c.checkpoint_dir))
    assert meta["init_from"]["path"] == str(tmp_path / "w.npz")
    assert summary["steps"] == 1
    # The default (from-scratch) lr on shipped weights warns.
    loop.train(cfg(tmp_path / "hi", epochs_stage_1=1, epochs_stage_2=0,
                   init_from_npz=str(tmp_path / "w.npz")), max_steps=1)
    assert "WARNING: warm-starting trained weights" in capsys.readouterr().out


def test_nan_guard_saves_emergency_checkpoint(tmp_path, monkeypatch):
    real = loop.make_train_step

    def poisoned(*args, **kwargs):
        step = real(*args, **kwargs)

        def bad(state, batch, generator):
            state, metrics = step(state, batch, generator)
            return state, {**metrics, "total": torch.tensor(float("nan"))}

        return bad

    monkeypatch.setattr(loop, "make_train_step", poisoned)
    with pytest.raises(FloatingPointError):
        loop.train(cfg(tmp_path, epochs_stage_1=1, epochs_stage_2=0))
    saved = list((tmp_path / "ck").glob("*NAN_ABORT*"))
    assert saved and tck.load_metadata(str(saved[0]))["reason"] == \
        "non-finite loss"


def test_eval_every_curve_replay_and_export_npz(tmp_path, capsys):
    """The probe writes eval_curve.jsonl rows for both domains before each
    save; stage 2 replays stage-1 batches; every save exports an npz whose
    sidecar names its subtree and which the JAX package's loader reads."""
    out_npz = tmp_path / "weights.npz"
    c = cfg(tmp_path, epochs_stage_1=1, epochs_stage_2=2, save_checkpoint=1,
            stage2_replay=0.5, eval_every=1, eval_probe_steps=2,
            ema_decay=0.9, export_npz=str(out_npz), log_every=1)
    summary = loop.train(c)
    assert "replaying a atmospheric batch every 2 steps" in \
        capsys.readouterr().out
    rows = [json.loads(l) for l in
            open(tmp_path / "o" / "eval_curve.jsonl")]
    assert {r["domain"] for r in rows} == {"atmospheric", "underwater"}
    assert [r["epoch"] for r in rows] == [1, 1, 1, 1, 2, 2]
    for r in rows:
        assert np.isfinite(r["psnr"]) and np.isfinite(r["psnr_ema"])
        assert r["n"] == 2 and r["probe_steps"] == 2
    side = json.loads((tmp_path / "weights.npz.json").read_text())
    assert side["subtree"] in ("params", "ema_params") and side["reason"]
    assert side["step"] == summary["state"].step
    assert side["probe"]["step"] == rows[-1]["step"]
    flat = jax_flatten(jax_load_npz(str(out_npz)))
    state = summary["state"]
    src = (state.ema_params if side["subtree"] == "ema_params"
           else {n: p.detach() for n, p in state.params.items()})
    assert len(flat) == len(src)
    from hybrid_diffusion_tpu_torch.weights import flat_from_state_dict

    want = flat_from_state_dict(src)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      v.astype(np.float16))
    names = os.listdir(tmp_path / "ck")
    assert any(n.startswith("ckpt_2_Underwater_final_") for n in names)
    assert "ckpt_1_Atmospheric_HICRDLoLI" in names


def test_joint_training_interleaves_domains(tmp_path):
    summary = loop.train(cfg(tmp_path, joint_training=True, epochs_stage_1=1,
                             epochs_stage_2=0))
    assert [s["stage"] for s in summary["stages"]] == ["Joint"]
    assert summary["steps"] == 2   # 8 + 8 images, batch 8


def test_device_data_trains_like_host_batches(tmp_path):
    """device_data=True (the corpus resident on the device) gives the run
    that host batches give, bit for bit."""
    runs = [loop.train(cfg(tmp_path / str(dd), epochs_stage_1=1,
                           epochs_stage_2=0, device_data=dd, batch_size=4))
            for dd in (False, True)]
    for (n, a), b in zip(runs[0]["model"].state_dict().items(),
                         runs[1]["model"].state_dict().values()):
        assert torch.equal(a, b), n


def _step_state(grad_accum, seed=0):
    from _torch_parity import tiny_pair

    _, _, model = tiny_pair(seed=seed)
    return TrainState(model, lr=1e-3, total_epochs=10, steps_per_epoch=5,
                      ema_decay=0.9, grad_accum=grad_accum)


def test_grad_accum_two_equals_one_batch_of_twice_the_size():
    from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
    from hybrid_diffusion_tpu_torch.losses import CompositeLossConfig

    step = loop.make_train_step(
        linear_beta_schedule(1e-4, 0.02, 20),
        CompositeLossConfig(dino_weight=0, ms_ssim_weight=0, color_weight=0),
        domain_routing=False)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
             for k in ("input", "gt")}
    t = torch.from_numpy(rng.integers(0, 20, (4,)))
    noise = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    big, acc = _step_state(1), _step_state(2)
    p0 = {n: p.detach().clone() for n, p in acc.params.items()}
    gen = torch.Generator()
    big, _ = step(big, batch, gen, t=t, noise=noise)
    half = [({k: v[s] for k, v in batch.items()}, t[s], noise[s])
            for s in (slice(0, 2), slice(2, 4))]
    acc, _ = step(acc, half[0][0], gen, t=half[0][1], noise=half[0][2])
    assert acc.step == 0 and acc.mini_step == 1
    for n, p in acc.params.items():
        assert torch.equal(p, p0[n]), n     # no update after one micro-batch
    acc, _ = step(acc, half[1][0], gen, t=half[1][1], noise=half[1][2])
    assert acc.step == big.step == 1 and acc.mini_step == 0
    # A bias before a GroupNorm has a gradient of rounding noise only, so
    # the moments are held against the largest of their kind over the
    # whole model, not tensor by tensor.
    scale = {k: max(float(big.moments(n)[k].abs().max()) for n in big.params)
             for k in ("exp_avg", "exp_avg_sq")}
    for n in big.params:
        for k in ("exp_avg", "exp_avg_sq"):
            err = float((acc.moments(n)[k] - big.moments(n)[k]).abs().max())
            assert err <= 1e-5 * scale[k], (n, k)
        # AdamW's first step is lr·g/(|g| + ε): where |g| is at the level
        # of the sum's rounding its sign may flip, so the parameters are
        # held where |g| ≥ 1e-4 of the largest, to 4 ulps.
        m = big.moments(n)["exp_avg"].abs()
        sure = m >= 1e-4 * scale["exp_avg"]
        for a, b in ((acc.params[n].detach(), big.params[n].detach()),
                     (acc.ema_params[n], big.ema_params[n])):
            if sure.any():
                ulps = 4 * float(np.spacing(np.float32(b.abs().max().item())))
                assert (a - b)[sure].abs().max() <= ulps, n


# Per micro-step: the gates (None: routing off) and the gradients' scale.
MICRO = [([1.0, 0.0, 1.0, 0.0], 3.0), ([0.0, 1.0, 0.0, 1.0], 0.05),
         ([0.0, 1.0, 0.0, 1.0], 1.0), ([1.0, 1.0, 0.0, 0.0], 0.2),
         (None, 0.5), ([1.0, 0.0, 1.0, 0.0], 2.0)]


def test_grad_accum_equals_optax_multisteps_on_the_same_gradients():
    """Three updates of k = 2 with the gates changing between the micro-
    steps: a block gated off at a micro-step keeps its running mean, one
    gated off at the update keeps its parameters and moments, as the JAX
    step's blend over optax.MultiSteps' state does."""
    torch.manual_seed(0)
    model = Toy()
    hyper = {k: v for k, v in HYPER.items() if k != "ema_decay"}
    state = TrainState(model, **hyper, grad_accum=2)
    jstate = jax_create_state(toy_tree(model), None, **hyper, grad_accum=2)
    rng = np.random.default_rng(0)
    for m, (gates, scale) in enumerate(MICRO):
        before = {n: p.detach().clone() for n, p in state.params.items()}
        grads = {n: (scale * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in state.params.items()}
        for n, p in state.params.items():
            p.grad = torch.from_numpy(grads[n].copy())
        gated_update(state, None if gates is None else torch.tensor(gates))
        jgrads = {"params": {c: {"kernel": jnp.asarray(grads[f"{c}.weight"].T),
                                 "bias": jnp.asarray(grads[f"{c}.bias"])}
                             for c in dict(model.named_children())}}
        old = jstate
        if gates is not None:
            jgrads = jax_apply_gates(jgrads, jnp.asarray(gates))
        jstate = jstate.apply_gradients(jgrads)
        if gates is not None:
            jg = jnp.asarray(gates)
            jstate = jstate.replace(
                params=jax_blend(jstate.params, old.params, jg),
                opt_state=jax_blend(jstate.opt_state, old.opt_state, jg))
        adam = jstate.opt_state.inner_opt_state[1][0]
        assert state.step == (m + 1) // 2 and state.mini_step == (m + 1) % 2
        for c, sub in jstate.params["params"].items():
            for leaf, name in (("kernel", "weight"), ("bias", "bias")):
                n = f"{c}.{name}"
                tr = (lambda a: np.asarray(a).T) if leaf == "kernel" else np.asarray
                ref = tr(sub[leaf])
                got = state.params[n].detach().numpy()
                base = before[n].numpy()
                ulps = 4 * (m + 1) * float(np.spacing(np.abs(base).max()))
                assert np.abs(got - ref).max() <= (
                    1e-5 * np.abs(ref - base).max() + ulps), (m, n)
                for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                    assert rel_err(state.moments(n)[key].numpy(),
                                   tr(tree["params"][c][leaf])) <= 1e-5, (m, n)
                acc = tr(jstate.opt_state.acc_grads["params"][c][leaf])
                assert rel_err(state.acc_grads[n].numpy(), acc) <= 1e-6, (m, n)


def test_fp32_calls_turn_tf32_off_and_restore_the_callers_flags():
    """Inside an fp32 sampler call and train step both TF32 flags are off;
    after it they are what the caller had; the bf16 path leaves them."""
    from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
    from hybrid_diffusion_tpu_torch.losses import CompositeLossConfig

    seen = []
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    saved = flags()
    try:
        for bf16 in (False, True):
            c = Config(**{**BASE, "bf16": bf16, "sampler": "dpm++2m",
                          "ddim_step": 2})
            model = loop.init_params(c, "cpu").eval()
            hook = model.head.register_forward_hook(
                lambda *a: seen.append(flags()))
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            loop.make_sampler(c, model)(torch.zeros(1, 16, 16, 3,
                                                    dtype=torch.uint8))
            assert flags() == (True, True)
            if not bf16:
                state = loop.create_train_state(c, model, 1)
                step = loop.make_train_step(linear_beta_schedule(1e-4, 0.02, 8),
                                            CompositeLossConfig(dino_weight=0))
                step(state, {k: np.zeros((1, 16, 16, 3), np.uint8)
                             for k in ("input", "gt")}, torch.Generator())
                assert flags() == (True, True)
                assert set(seen) == {(False, False)}
            else:
                assert seen[-1] == (True, True)
            hook.remove()
        with pytest.raises(KeyError):
            with precision.full_fp32():
                raise KeyError("restored on the way out too")
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


def test_cli_dispatch(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(loop, "train", lambda c: calls.append(("train", c)))
    monkeypatch.setattr(loop, "evaluate",
                        lambda c, split: calls.append((split, c)) or {})
    monkeypatch.setattr(loop, "enhance_image",
                        lambda c: calls.append(("enhance", c)))
    assert cli.main(["--state", "train", "--device", "cpu", "--no-bf16",
                     "--channel_mult", "1", "2", "--mesh_data", "1"]) == 0
    assert cli.main(["--state", "eval"]) == 0
    assert cli.main(["--state", "inference"]) == 0
    assert cli.main(["--state", "test", "--inference_image", "x.png"]) == 0
    assert cli.main(["--state", "bogus"]) == 2
    assert [k for k, _ in calls] == ["train", "val", "test", "enhance"]
    c = calls[0][1]
    assert c.device == "cpu" and not c.bf16 and list(c.channel_mult) == [1, 2]
    assert calls[1][1].device == "cuda"         # the card by default
    # The parallel flags parse; a mesh that the world cannot hold raises
    # ValueError where an entry point starts, before any work.
    par = parse_config(["--mesh_model", "2", "--mesh_data", "1", "--zero1"])
    assert (par.mesh_data, par.mesh_model, par.zero1) == (1, 2, True)
    assert Config(zero1=True).zero1 and Config().mesh_data is None
    for bad in (dict(mesh_model=2), dict(mesh_data=2)):
        with pytest.raises(ValueError, match="devices"):
            loop._start_ranks(Config(device="cpu", **bad))
    assert Config().stage_loss_config(1) == Config().loss_config
    assert Config(stage2_losses="dino=0,color=2").stage_loss_config(1) \
        .color_weight == 2.0


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch,
                                                               tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = Config(**{**BASE, "device": "cuda"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.evaluate(c)


def test_entry_points_refuse_a_process_group(tmp_path):
    """The name is historical: train() and evaluate() refused a process
    group while the port ran in one process only. Now, under an initialized
    group (gloo, world size 1, a file store) they run on a 1×1 mesh and
    give the state and images that one process gives: the same parameters,
    AdamW moments and EMA, the same checkpoint, the same sampled bytes."""
    dist = torch.distributed

    def run(tag):
        c = cfg(tmp_path / tag, ema_decay=0.5, save_checkpoint=1,
                epochs_stage_2=0, ddim_step=4)
        summary = loop.train(c, max_steps=2)
        state = summary["state"]
        ck = summary["stages"][0]["checkpoint"]
        res = loop.evaluate(dataclasses.replace(c, state="test"),
                            checkpoint_path=ck, compute_fid=False)
        images = sorted((tmp_path / tag / "o").rglob("*.png"))
        return dict(mesh=state.mesh,
                    params={n: p.detach().clone()
                            for n, p in state.params.items()},
                    moments={n: state.moments(n)["exp_avg"].clone()
                             for n in state.params},
                    ema=dict(state.ema_params), results=res,
                    payload=tck._load_payload(ck),
                    images=[np.asarray(load_image(str(p))) for p in images])

    alone = run("alone")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        grouped = run("grouped")
    finally:
        dist.destroy_process_group()
    assert alone["mesh"] is None and tuple(grouped["mesh"].shape) == (1, 1)
    for key in ("params", "moments", "ema"):
        for n, t in alone[key].items():
            assert torch.equal(grouped[key][n], t), (key, n)
    timing = ("sample_wall_s", "fetch_block_s", "time_cost", "fid")
    assert grouped["results"].keys() == alone["results"].keys()
    for domain, res in alone["results"].items():
        assert {k: v for k, v in grouped["results"][domain].items()
                if k not in timing} == {k: v for k, v in res.items()
                                        if k not in timing}
    for key in ("params", "ema_params"):
        for n, t in alone["payload"][key].items():
            assert torch.equal(grouped["payload"][key][n], t), (key, n)
    assert alone["payload"]["step"] == grouped["payload"]["step"] == 2
    assert len(alone["images"]) == len(grouped["images"]) > 0
    for a, b in zip(alone["images"], grouped["images"]):
        np.testing.assert_array_equal(a, b)


def test_evaluate_ragged_batch_and_enhance_image(tmp_path):
    """evaluate() pads the ragged final batch and scores exactly the real
    images, quantized on the device (FID off), on 0-255 images; FID on
    adds the FID keys; enhance_image writes its file."""
    c = cfg(tmp_path, synthetic_length=56, batch_size=6, sampler="dpm++2m",
            ddim_step=2)
    res = loop.evaluate(c, split="val", compute_fid=False, save_images=True)
    for dom in ("underwater", "atmospheric"):
        r = res[dom]
        assert r["n_images"] == 8      # 56 // 7 val images: 6 + ragged 2
        assert np.isfinite(r["psnr"]) and r["uism"] > 0.0
        assert abs(r["uiconm"]) > 1e-6 and "fid_pretrained" not in r
        assert "fid_block_s" not in r
        for k in ("sample_wall_s", "fetch_block_s", "time_cost"):
            assert r[k] >= 0.0
        assert len(os.listdir(tmp_path / "o" / "result"
                              / f"synthetic-{dom}" / "val")) == 8
        assert (tmp_path / "o" / "result" / f"synthetic-{dom}"
                / "res.txt").read_text().startswith("split=val n=8 ")
    fid = loop.evaluate(cfg(tmp_path, synthetic_length=7, batch_size=2,
                            sampler="dpm++2m", ddim_step=1),
                        split="test", save_images=False)
    assert fid["underwater"]["fid_pretrained"] == 0.0
    assert fid["underwater"]["fid_block_s"] >= 0.0
    assert np.isfinite(fid["underwater"]["fid"])
    img = tmp_path / "o" / "result" / "synthetic-underwater" / "val" / \
        "synthetic_underwater_00000.png"
    out = loop.enhance_image(c, str(img), str(tmp_path / "e.png"))
    assert out.shape == (16, 16, 3) and (tmp_path / "e.png").exists()

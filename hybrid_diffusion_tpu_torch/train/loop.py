"""Orchestration: staged two-domain training, evaluation, inference.

Counterpart of `hybrid_diffusion_tpu/train/loop.py`: `build_model`
(:67-77), `init_params` (:80-91), `_make_dino` (:124-132), `train`
(:146-720), `make_sampler` (:723-778), `enhance_image` (:781-813) and
`evaluate` (:816-968), on one card:

  - staged training (atmospheric stage, then underwater stage, each with a
    fresh optimizer and warmup-cosine) or joint training (both domains'
    loaders interleaved), `stage2_replay`, stage-aware `resume_from` (a
    path or "auto"), the `init_from_npz` warm start, the `max_steps`
    budget, the NaN guard's emergency checkpoint, the `eval_every` probe,
    periodic and stage-final checkpoints with the npz export and its
    sidecar, and SIGTERM's preempt checkpoint;
  - evaluation: DPM++2M/DDIM sampling on the card, at most two batches in
    flight, and PSNR/SSIM/UIQM/UCIQE/FID per domain, with the per-image
    CPU metrics on a two-thread pool and a `res.txt` per domain.

Every entry point runs on `config.device` ("cuda" by default; it raises
without a card unless the caller asks for "cpu"). An fp32 configuration
(`bf16=False`) runs its device work with TF32 off (utils/precision.py).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..data import BatchLoader, make_dataset
from ..data.pipeline import DeviceBatchLoader, device_prefetch, interleave
from ..diffusion import ddim_sample, dpm_solver_pp_2m_sample, linear_beta_schedule
from ..losses import DinoPerceptualLoss
from ..models import DynamicUNet
from ..utils.device import require_single_process, resolve_device
from ..utils.precision import precision_for
from ..utils.profiling import profile_trace, timed_block
from ..weights import load_npz_state_dict
from .checkpoint import (
    choose_subtree_from_evidence,
    find_checkpoint,
    find_latest_checkpoint,
    load_metadata,
    restore_params,
    restore_partial,
    restore_state,
    save_checkpoint,
    wait_for_checkpoints,
)
from .logging import MetricsLogger
from .step import make_train_step, normalize_uint8
from .train_state import TrainState


def build_model(config: Config) -> DynamicUNet:
    """The DynamicUNet of `config`, bf16 compute when `config.bf16`."""
    return DynamicUNet(
        T=config.T,
        ch=config.channel,
        ch_mult=tuple(config.channel_mult),
        num_res_blocks=config.num_res_blocks,
        dtype=torch.bfloat16 if config.bf16 else torch.float32,
        dropout=config.dropout,
        remat=config.remat,
    )


def init_params(config: Config, device="cuda") -> DynamicUNet:
    """The model of `config` on `device`, its parameters initialized with
    the JAX model's init drawn from `config.seed` (the global generator's
    state is left as it was), then loaded from `config.pretrained_path`
    (a checkpoint or a params npz), or for the eval states from the
    checkpoint of `config.epoch` under `checkpoint_dir`, or else from
    `config.init_from_npz` (a warm start) when set."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_model(config)
    path = config.pretrained_path
    if not path and config.state in ("eval", "test", "enhance"):
        path = find_checkpoint(config.checkpoint_dir, config.epoch)
    if path:
        restore_params(path, model)
        print(f"[params] restored from {path}")
    elif config.init_from_npz:
        model.load_state_dict(load_npz_state_dict(config.init_from_npz),
                              strict=True)
    return model.to(device)


def create_train_state(config: Config, model: DynamicUNet,
                       steps_per_epoch: int,
                       total_epochs: Optional[int] = None) -> TrainState:
    """A fresh optimizer over `model` with the configuration's lr, decay,
    clip, warmup-cosine over `total_epochs` (default epochs_stage_1), EMA
    and gradient accumulation, as the JAX `train` makes one per stage."""
    return TrainState(
        model, lr=config.lr, weight_decay=config.weight_decay,
        grad_clip=config.grad_clip,
        total_epochs=total_epochs or config.epochs_stage_1,
        steps_per_epoch=steps_per_epoch, multiplier=config.multiplier,
        ema_decay=config.ema_decay, grad_accum=config.grad_accum)


def make_dino(config: Config, device="cuda") -> Optional[DinoPerceptualLoss]:
    """The DINO extractor when the loss uses it (random init from seed 1,
    or HDT_DINO_WEIGHTS), computing in bf16 when `config.bf16`."""
    if not config.dino_weight:
        return None
    return DinoPerceptualLoss(
        seed=1, dtype=torch.bfloat16 if config.bf16 else torch.float32,
        device=resolve_device(device))


def _make_dino(config: Config, stage_cfgs, device) -> Optional[DinoPerceptualLoss]:
    """One DINO extractor shared by every stage whose loss uses it."""
    if not any(c.dino_weight for c in stage_cfgs):
        return None
    return make_dino(dataclasses.replace(config, dino_weight=1.0), device)


def _make_vgg(config: Config, stage_cfgs) -> None:
    """The VGG/alex/squeeze taps are not ported: a stage that weights them
    raises, as the port's composite loss does."""
    if any(c.vgg_weight for c in stage_cfgs):
        raise NotImplementedError(
            "the VGG perceptual term (vgg_weight > 0) is not ported yet "
            "(ROADMAP.md, queue 1, item 2)")


def _dataset_name(config: Config, domain: str) -> str:
    if config.synthetic_data:
        return f"synthetic-{domain}"
    return (config.underwater_data_name if domain == "underwater"
            else config.atmospheric_data_name)


def _loader(config: Config, domain: str, task: str, shuffle: bool):
    """The split's loader; a ragged final batch is kept (one card)."""
    ds = make_dataset(
        _dataset_name(config, domain), task=task,
        dataset_path=config.dataset_path, image_size=config.img_size,
        supervised=config.supervised,
        synthetic_length=config.synthetic_length,
    )
    if config.device_data and task == "train":
        return DeviceBatchLoader(ds, config.batch_size, config.device,
                                 shuffle=shuffle, seed=config.seed,
                                 drop_last=False)
    return BatchLoader(ds, config.batch_size, shuffle=shuffle,
                       seed=config.seed, num_workers=config.num_workers,
                       drop_last=False)


def _warm_start_meta(path: str) -> dict:
    """{"path", "src_step"} of a warm-start npz; the sidecar is provenance
    only, so a missing or malformed one gives src_step None."""
    src_step = None
    try:
        with open(path + ".json") as f:
            src_step = json.load(f).get("step")
    except (OSError, ValueError):
        pass
    return {"path": path, "src_step": src_step}


def _with_replay(main_iter, rep_ld, period):
    """Every `period`-th batch of `main_iter` replaced by one of `rep_ld`."""
    rep = iter(rep_ld)
    for i, b in enumerate(main_iter):
        if (i + 1) % period == 0:
            try:
                yield next(rep)
            except StopIteration:
                rep = iter(rep_ld)
                yield next(rep)
        else:
            yield b


def train(config: Config, max_steps: Optional[int] = None) -> dict:
    """Two-stage training. Returns a summary dict: stages (name,
    last loss, checkpoint), steps, preempted, and the trained `model`."""
    # SIGTERM requests a graceful stop: a resumable checkpoint at the next
    # epoch boundary (`--resume_from auto` picks it up). Installed first.
    preempt = {"flag": False}

    def _on_sigterm(signum, frame):
        preempt["flag"] = True
        print("[train] SIGTERM — will checkpoint and stop at epoch end")

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        prev_handler = None  # not the main thread
    try:
        return _train(config, max_steps, preempt)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def _train(config: Config, max_steps: Optional[int], preempt: dict) -> dict:
    require_single_process()
    device = resolve_device(config.device)
    # Resolve the resume target before the warm start: on the first segment
    # of a `--resume_from auto` run there is no checkpoint yet, and a
    # configured --init_from_npz wins instead of raising.
    resume_path = None
    if config.resume_from:
        resume_path = config.resume_from
        if resume_path == "auto":
            resume_path = find_latest_checkpoint(config.checkpoint_dir)
            if resume_path is None:
                if not config.init_from_npz:
                    raise FileNotFoundError(
                        f"--resume_from auto: no ckpt_* directories under "
                        f"{config.checkpoint_dir}")
                print("[train] --resume_from auto: no checkpoint yet — "
                      "falling back to the --init_from_npz warm-start")
    model = init_params(dataclasses.replace(config, init_from_npz=""), device)
    warm_meta = None
    if config.init_from_npz and resume_path is None:
        # A new run standing on shipped weights: fresh optimizer and
        # schedule (fp16 storage -> fp32 master weights).
        model.load_state_dict(load_npz_state_dict(config.init_from_npz),
                              strict=True)
        warm_meta = _warm_start_meta(config.init_from_npz)
        src_step = warm_meta["src_step"]
        print(f"[train] warm-start params from {config.init_from_npz}"
              + (f" (exported at step {src_step})"
                 if src_step is not None else ""))
        if config.lr >= type(config).lr:
            print(f"[train] WARNING: warm-starting trained weights with "
                  f"lr={config.lr:g} (>= the from-scratch default "
                  f"{type(config).lr:g}) and a full warmup-cosine — this "
                  f"can degrade the shipped weights; fine-tunes usually "
                  f"want --lr 1e-5.")
    schedule = linear_beta_schedule(config.beta_1, config.beta_T, config.T)
    logger = MetricsLogger(config.wandb, project=config.wandb_name,
                           config=config.__dict__)

    datasets_tag = f"{config.underwater_data_name}{config.atmospheric_data_name}"
    if config.joint_training:
        stages = [("Joint", "both", config.epochs_stage_1)]
    else:
        stages = [
            ("Atmospheric", "atmospheric", config.epochs_stage_1),
            ("Underwater", "underwater", config.epochs_stage_2),
        ]
    stage_cfgs = [config.stage_loss_config(i) for i in range(len(stages))]
    _make_vgg(config, stage_cfgs)
    dino = _make_dino(config, stage_cfgs, device)
    step_cache: dict = {}

    def stage_step_fn(loss_cfg):
        if loss_cfg not in step_cache:
            step_cache[loss_cfg] = make_train_step(
                schedule, loss_cfg,
                dino_loss_fn=dino if loss_cfg.dino_weight else None,
                use_conditioning=config.use_conditioning,
                p_uncond=config.p_uncond,
                domain_routing=config.domain_routing)
        return step_cache[loss_cfg]

    generator = torch.Generator(device).manual_seed(config.seed)
    summary = {"stages": [], "steps": 0, "preempted": False}
    resumed = False
    # Stage-aware resume: a run preempted in stage 2 resumes INTO stage 2,
    # and a stage-final checkpoint resumes at the NEXT stage.
    resume_start_stage = 0
    resume_stage_finished = False
    ck_meta: dict = {}
    if resume_path is not None:
        ck_meta = load_metadata(resume_path)
        # Later segments keep naming the artifact the whole run stands on.
        if ck_meta.get("init_from"):
            warm_meta = ck_meta["init_from"]
        elif config.init_from_npz:
            warm_meta = _warm_start_meta(config.init_from_npz)
        stage_names = [s[0] for s in stages]
        if ck_meta.get("stage") in stage_names:
            idx = stage_names.index(ck_meta["stage"])
            finished = (not ck_meta.get("preempted", False)
                        and "_final_" in os.path.basename(resume_path))
            resume_start_stage = min(idx + (1 if finished else 0),
                                     len(stages) - 1)
            # Crossing a stage boundary restores params (+EMA) only: the
            # next stage gets a fresh optimizer and warmup-cosine.
            resume_stage_finished = finished and resume_start_stage > idx
    # Short run id in stage-final/preempt names, so two runs of one
    # configuration never share a directory.
    run_id = time.strftime("%m%d%H%M")
    probe_state: dict = {"batches": {}}

    def export_npz_snapshot(state: TrainState) -> None:
        """The current best sampling weights (by the shared subtree policy)
        as a flat fp16 npz at config.export_npz, atomically, with a .json
        sidecar naming the subtree, step and evidence."""
        if not config.export_npz:
            return
        from ..weights import save_npz_state_dict

        step = int(state.step)
        has_ema = state.ema_params is not None and bool(state.ema_decay)
        subtree, reason = choose_subtree_from_evidence(
            has_ema, step, state.ema_decay, probe_state.get("last"))
        use_ema = subtree == "ema_params"
        out = os.path.abspath(config.export_npz)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        t0 = time.time()
        tmp = f"{out}.tmp.{os.getpid()}.npz"
        save_npz_state_dict(tmp, state.ema_params if use_ema
                            else state.model.state_dict())
        side_tmp = f"{out}.json.tmp.{os.getpid()}"
        with open(side_tmp, "w") as f:
            json.dump({"step": step,
                       "subtree": subtree,
                       "reason": reason,
                       "ema_decay": state.ema_decay,
                       "ema_init_mass": (state.ema_decay ** step
                                         if has_ema else None),
                       "probe": probe_state.get("last"),
                       "init_from": warm_meta,
                       "run_id": run_id}, f)
        os.replace(tmp, out)
        os.replace(side_tmp, out + ".json")
        print(f"[export] {out}: subtree={'ema' if use_ema else 'raw'} "
              f"step={step} ({time.time() - t0:.1f}s)")

    def run_eval_probe(state: TrainState, stage_name, probe_domains, epoch):
        """DPM++(2M) val PSNR of the raw parameters and the EMA on a pinned
        subset, appended to <output_path>/eval_curve.jsonl."""
        from ..metrics import psnr as _psnr

        probe_steps = min(config.eval_probe_steps, config.T)
        probe_cfg = dataclasses.replace(config, sampler="dpm++2m",
                                        ddim_step=probe_steps,
                                        unconditional_guidance_scale=1.0)
        rows = []
        for dom in probe_domains:
            if dom not in probe_state["batches"]:
                ld = _loader(config, dom, "val", shuffle=False)
                # Pinned once, the inputs on the card; gt stays on the host
                # for the numpy PSNR.
                probe_state["batches"][dom] = [
                    {"input": torch.from_numpy(np.asarray(b["input"])).to(device),
                     "gt": b["gt"]}
                    for _, b in zip(range(config.eval_probe_batches), ld)]
            variants = [("psnr", None)]
            if state.ema_params is not None:
                variants.append(("psnr_ema", state.ema_params))
            row = {"stage": stage_name, "epoch": epoch + 1,
                   "step": int(state.step), "domain": dom,
                   "probe_steps": probe_steps, "time": time.time()}
            for key, probe_params in variants:
                sampler = make_sampler(probe_cfg, state.model,
                                       quantize_uint8=True,
                                       params=probe_params)
                total, n = 0.0, 0
                for bi, b in enumerate(probe_state["batches"][dom]):
                    gen = torch.Generator(device).manual_seed(config.seed + bi)
                    out_u8 = sampler(b["input"], gen).cpu().numpy()
                    for i in range(out_u8.shape[0]):
                        total += _psnr(b["gt"][i], out_u8[i], data_range=255)
                        n += 1
                if n:
                    row[key] = round(total / n, 3)
                    row["n"] = n
            if "psnr" in row:
                rows.append(row)
        if rows:
            # Latest probe means feed the export's subtree decision.
            probe_state["last"] = {
                "step": rows[0]["step"],
                "psnr": round(sum(r["psnr"] for r in rows) / len(rows), 3),
            }
            if all("psnr_ema" in r for r in rows):
                probe_state["last"]["psnr_ema"] = round(
                    sum(r["psnr_ema"] for r in rows) / len(rows), 3)
            os.makedirs(config.output_path, exist_ok=True)
            with open(os.path.join(config.output_path,
                                   "eval_curve.jsonl"), "a") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")
            print("[eval_probe] " + "  ".join(
                f"{r['domain']}: {r['psnr']:.2f} dB"
                + (f" (ema {r['psnr_ema']:.2f})" if "psnr_ema" in r else "")
                for r in rows))

    state = None
    for stage_index, (stage_name, domain, stage_epochs) in enumerate(stages):
        if stage_epochs <= 0:
            continue
        if stage_index < resume_start_stage:
            print(f"[train] resume: skipping completed stage {stage_name}")
            continue
        if domain == "both":
            loaders = [_loader(config, "atmospheric", "train", shuffle=True),
                       _loader(config, "underwater", "train", shuffle=True)]
        else:
            loaders = [_loader(config, domain, "train", shuffle=True)]
        # Stage-2+ replay: every round(1/f)-th batch comes from the stage-1
        # domain instead (the step budget is unchanged).
        replay_loader = None
        if (config.stage2_replay > 0 and stage_index > 0
                and domain in ("atmospheric", "underwater")):
            other = ("atmospheric" if domain == "underwater"
                     else "underwater")
            replay_loader = _loader(config, other, "train", shuffle=True)
            replay_period = max(int(round(1.0 / config.stage2_replay)), 1)
            print(f"[train] stage {stage_name}: replaying a {other} batch "
                  f"every {replay_period} steps (stage2_replay="
                  f"{config.stage2_replay:g})")
        # The schedule counts optimizer updates: k micro-batches, one.
        steps_per_epoch = max(
            sum(len(l) for l in loaders) // max(config.grad_accum, 1), 1)
        # Fresh optimizer per stage; the same model carries over.
        state = create_train_state(config, model, steps_per_epoch,
                                   total_epochs=stage_epochs)
        step_fn = stage_step_fn(stage_cfgs[stage_index])
        loss_meta = dataclasses.asdict(stage_cfgs[stage_index])
        if resume_path and not resumed:
            if resume_stage_finished:
                restored = restore_partial(resume_path,
                                           ("params", "ema_params"))
                with torch.no_grad():
                    model.load_state_dict(restored["params"], strict=True)
                    if state.ema_params is not None:
                        src = restored.get("ema_params", restored["params"])
                        for n, e in state.ema_params.items():
                            e.copy_(src[n])
                summary["steps"] = int(ck_meta.get("step") or 0)
                print(f"[train] resumed params from finished stage "
                      f"checkpoint {resume_path} "
                      f"(step {summary['steps']}, fresh optimizer)")
            else:
                saved_loss = ck_meta.get("loss_config")
                if saved_loss is not None and saved_loss != loss_meta:
                    diff = {k: (saved_loss.get(k), v)
                            for k, v in loss_meta.items()
                            if saved_loss.get(k) != v}
                    print(
                        "[train] WARNING: full-state resume with a CHANGED "
                        f"loss set {diff} — the restored Adam moments are "
                        "calibrated to the old objective; their tiny second "
                        "moments amplify any new loss term's gradients. "
                        "To fine-tune with a new loss set, pass the "
                        "checkpoint as --pretrained_path instead: params-"
                        "only init, fresh optimizer + warmup.")
                restore_state(resume_path, state, generator)
                # The restored micro-steps count against max_steps, so a
                # resumed run finishes the original budget.
                summary["steps"] = (state.step * state.grad_accum
                                    + state.mini_step)
                print(f"[train] resumed full state from {resume_path} "
                      f"(step {state.step})")
            resumed = True

        last_metrics: dict = {}
        metrics = None  # set by the first executed step
        epochs_done = 0
        for epoch in range(stage_epochs):
            for ld in loaders:
                ld.set_epoch(epoch)
            batch_iter = (iter(loaders[0]) if len(loaders) == 1
                          else interleave(*loaders))
            if replay_loader is not None:
                replay_loader.set_epoch(epoch)
                batch_iter = _with_replay(batch_iter, replay_loader,
                                          replay_period)
            t_epoch = time.time()
            pairs = ({"input": b["input"], "gt": b["gt"]} for b in batch_iter)
            if getattr(loaders[0], "device_resident", False):
                batches = pairs         # gathered on the card already
            else:
                batches = device_prefetch(pairs, device)
            for arrays in batches:
                # Budget check BEFORE the step: a resumed run whose
                # restored step already meets max_steps runs zero.
                if max_steps and summary["steps"] >= max_steps:
                    break
                state, metrics = step_fn(state, arrays, generator)
                summary["steps"] += 1
                if (config.log_every
                        and summary["steps"] % config.log_every == 0):
                    logger.log(metrics, step=state.step,
                               prefix=f"Train {stage_name}/")
                if max_steps and summary["steps"] >= max_steps:
                    break
            if metrics is None:  # zero steps ran (budget already met)
                break
            epochs_done = epoch + 1
            last_metrics = logger.log(metrics, step=state.step,
                                      prefix=f"Train {stage_name}/")
            sps = steps_per_epoch / max(time.time() - t_epoch, 1e-9)
            gn = last_metrics.get("grad_norm")
            print(f"[{stage_name}] epoch {epoch+1}/{stage_epochs} "
                  f"loss={last_metrics.get('total', float('nan')):.4f} "
                  + (f"gnorm={float(gn):.2f} " if gn is not None else "")
                  + f"{sps:.2f} steps/s")
            # A non-finite loss aborts the stage after an emergency save
            # (checked once an epoch: a per-step check would sync the card).
            if not np.isfinite(last_metrics.get("total", 0.0)):
                path = save_checkpoint(
                    config.checkpoint_dir, epoch + 1,
                    f"{stage_name}_NAN_ABORT", datasets_tag, state,
                    metadata={"stage": stage_name, "epoch": epoch + 1,
                              "loss_config": loss_meta,
                              "init_from": warm_meta,
                              "reason": "non-finite loss"},
                    generator=generator)
                logger.alert("non-finite loss", path)
                raise FloatingPointError(
                    f"non-finite loss at {stage_name} epoch {epoch+1}; "
                    f"emergency checkpoint: {path}")
            # Probe BEFORE the save, so the checkpoint and the export carry
            # evidence from the state being saved; both domains, so that
            # cross-domain forgetting shows.
            if config.eval_every and (epoch + 1) % config.eval_every == 0:
                run_eval_probe(state, stage_name,
                               ("atmospheric", "underwater"), epoch)
            if (epoch + 1) % config.save_checkpoint == 0:
                path = save_checkpoint(
                    config.checkpoint_dir, epoch + 1, stage_name,
                    datasets_tag, state,
                    metadata={"stage": stage_name, "epoch": epoch + 1,
                              "loss_config": loss_meta,
                              "init_from": warm_meta,
                              "probe": probe_state.get("last")},
                    block=not config.async_checkpoint, generator=generator)
                logger.alert("checkpoint", path)
                export_npz_snapshot(state)
            if max_steps and summary["steps"] >= max_steps:
                break
            if preempt["flag"]:
                break

        wait_for_checkpoints()
        suffix = "_PREEMPT" if preempt["flag"] else "_final"
        path = save_checkpoint(config.checkpoint_dir, epochs_done,
                               f"{stage_name}{suffix}_{run_id}",
                               datasets_tag, state,
                               metadata={"stage": stage_name,
                                         "epoch": epochs_done,
                                         "loss_config": loss_meta,
                                         "init_from": warm_meta,
                                         "probe": probe_state.get("last"),
                                         "preempted": preempt["flag"]},
                               generator=generator)
        export_npz_snapshot(state)
        summary["stages"].append(
            {"stage": stage_name, "last_loss": last_metrics.get("total"),
             "checkpoint": path})
        if preempt["flag"]:
            summary["preempted"] = True
            logger.alert("preempted — resumable checkpoint saved", path)
            break
        if max_steps and summary["steps"] >= max_steps:
            break

    wait_for_checkpoints()
    logger.finish()
    summary["model"] = model
    summary["state"] = state
    return summary


def make_sampler(config: Config, model: DynamicUNet,
                 quantize_uint8: bool = False,
                 params: Optional[dict] = None) -> Callable[..., torch.Tensor]:
    """sample_fn(cond_u8, generator=None, init_noise=None) over the [-1, 1]
    pipeline: uint8 NHWC in, [0, 1] float (or, with quantize_uint8,
    clip(x·255, 0, 255) as uint8) NHWC out, on cond_u8's device.

    The model samples the way it was trained: without use_conditioning the
    condition embedding stays zeroed (guidance 1.0 uses that default).
    `params` ({name: tensor}, e.g. a train state's EMA) replace the model's
    own parameters for the call. An fp32 model samples with TF32 off.
    """
    schedule = linear_beta_schedule(config.beta_1, config.beta_T, config.T)
    uncond_default = not config.use_conditioning
    guidance = config.unconditional_guidance_scale

    def denoise(x6, t, context_zero=None):
        if context_zero is None:
            context_zero = uncond_default
        if params is None:
            return model(x6, t, context_zero=context_zero)
        return torch.func.functional_call(model, params, (x6, t),
                                          {"context_zero": context_zero})

    @torch.no_grad()
    def sample_fn(cond_u8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        with precision_for(config.bf16):
            cond = normalize_uint8(cond_u8)
            if config.sampler == "dpm++2m":
                out = dpm_solver_pp_2m_sample(denoise, schedule, cond,
                                              generator,
                                              steps=config.ddim_step,
                                              guidance_scale=guidance,
                                              init_noise=init_noise)
            elif config.ddim:
                out = ddim_sample(denoise, schedule, cond, generator,
                                  ddim_steps=config.ddim_step,
                                  guidance_scale=guidance,
                                  init_noise=init_noise)
            else:
                raise NotImplementedError(
                    "ddpm_sample is not ported yet (ROADMAP.md, queue 1, "
                    "item 3.1)")
            out01 = (out + 1.0) / 2.0
            if quantize_uint8:
                return (out01 * 255.0).clamp(0, 255).to(torch.uint8)
            return out01

    return sample_fn


def enhance_image(config: Config, image_path: Optional[str] = None,
                  output_path: Optional[str] = None,
                  model: Optional[DynamicUNet] = None) -> np.ndarray:
    """Enhance one image file end to end (CLI: --inference_image): load,
    resize to config.img_size, sample conditioned on it, write
    <output_path or output_path/enhanced_<name>>; returns the uint8 RGB
    array."""
    from ..data.registry import load_image, resize_image, save_image

    image_path = image_path or config.inference_image
    if not image_path:
        raise ValueError("no image path: set --inference_image")
    device = resolve_device(config.device)
    eval_cfg = dataclasses.replace(config, dropout=0.0)
    if model is None:
        model = init_params(eval_cfg, device)
    sampler = make_sampler(eval_cfg, model.eval(), quantize_uint8=True)
    img = resize_image(load_image(image_path), config.img_size)
    gen = torch.Generator(device).manual_seed(config.seed)
    with timed_block("enhance"):
        out_u8 = sampler(torch.from_numpy(img[None]).to(device),
                         gen)[0].cpu().numpy()
    if output_path is None:
        os.makedirs(config.output_path, exist_ok=True)
        output_path = os.path.join(
            config.output_path, f"enhanced_{os.path.basename(image_path)}")
    save_image(output_path, out_u8)
    print(f"[enhance] wrote {output_path}")
    return out_u8


def evaluate(config: Config, split: str = "test",
             checkpoint_path: Optional[str] = None,
             compute_fid: bool = True,
             save_images: bool = True) -> dict:
    """Metric sweep over one split for both domains.

    Returns {domain: {psnr, ssim, uiqm, uciqe, uism, uicm, uiconm, uiqm_nd,
    sample_wall_s, fetch_block_s, fid, fid_block_s and fid_pretrained (with
    FID), n_images, time_cost}} and appends a line to res.txt per domain.
    fetch_block_s is the host's wait for the samples; fid_block_s its time
    in the FID update, which waits for the card's next batch and the
    Inception pass.
    `checkpoint_path` (a checkpoint or a params npz) takes the place of
    `config.pretrained_path`.
    """
    from ..data.registry import save_image
    from ..metrics import FID, StreamingFID, getUIQM, nmetrics, psnr, ssim_index

    require_single_process()
    device = resolve_device(config.device)
    # Eval runs with dropout 0 (the reference loads the net with dropout 0).
    eval_cfg = dataclasses.replace(
        config, dropout=0.0,
        pretrained_path=checkpoint_path or config.pretrained_path)
    model = init_params(eval_cfg, device).eval()
    fid_model = (FID(image_size=config.img_size, device=device)
                 if compute_fid else None)
    # With FID off the sampler quantizes to uint8 on the card: every
    # consumer starts from clip(x·255).astype(uint8), and the copy to the
    # host is 4× smaller. StreamingFID takes the float samples.
    sampler = make_sampler(eval_cfg, model, quantize_uint8=fid_model is None)

    results = {}
    for domain in ("underwater", "atmospheric"):
        loader = _loader(config, domain, split, shuffle=False)
        if len(loader) == 0:
            continue
        stream = StreamingFID(fid_model) if fid_model else None
        sums = dict(psnr=0.0, ssim=0.0, uiqm=0.0, uciqe=0.0, uism=0.0,
                    uicm=0.0, uiconm=0.0, uiqm_nd=0.0)
        n = 0
        t0 = time.time()
        out_dir = os.path.join(config.output_path, "result",
                               _dataset_name(config, domain), split)
        if save_images:
            os.makedirs(out_dir, exist_ok=True)
        generator = torch.Generator(device).manual_seed(config.seed)

        def staged_batches():
            """Padded batches, the input on the card 2 batches ahead."""
            buf: collections.deque = collections.deque()

            def stage(b):
                # Pad a ragged final batch up to batch_size (repeat-edge):
                # one shape for the sweep; padded outputs are sliced off.
                n_act = b["input"].shape[0]
                inp = b["input"]
                if n_act < config.batch_size:
                    inp = np.concatenate(
                        [inp] + [inp[-1:]] * (config.batch_size - n_act))
                return (torch.from_numpy(inp).to(device), b["gt"], b["name"],
                        n_act)

            for b in loader:
                buf.append(stage(b))
                if len(buf) > 2:
                    yield buf.popleft()
            while buf:
                yield buf.popleft()

        def score_image(gt, img, name):
            row = {"psnr": psnr(gt, img, data_range=255),
                   "ssim": ssim_index(gt, img, data_range=255)}
            # uint8 0-255: the UIQM family is range-sensitive.
            (row["uiqm"], row["uciqe"], row["uism"],
             row["uicm"], row["uiconm"]) = nmetrics(img)
            row["uiqm_nd"] = getUIQM(img)
            if save_images:
                save_image(os.path.join(out_dir, name), img)
            return row

        pool = ThreadPoolExecutor(max_workers=2)
        futs: list = []
        inflight: collections.deque = collections.deque()
        fetch_block_s = fid_block_s = 0.0

        def drain_one():
            nonlocal fetch_block_s, fid_block_s, n
            dev_out, gt, names, n_act = inflight.popleft()
            tb0 = time.time()
            sampled = dev_out[:n_act].cpu().numpy()
            fetch_block_s += time.time() - tb0
            if stream is not None:
                # The Inception pass is queued behind the next batch's
                # sampling, so the copy of its features off the card waits
                # for both: the host's other wait on the card.
                tb0 = time.time()
                stream.update(gt.astype(np.float32) / 255.0, dev_out[:n_act])
                fid_block_s += time.time() - tb0
            for i in range(sampled.shape[0]):
                img = (sampled[i] if sampled.dtype == np.uint8 else
                       np.clip(sampled[i] * 255.0, 0, 255).astype(np.uint8))
                futs.append(pool.submit(score_image, gt[i], img, names[i]))
                n += 1

        try:
            # Sampling is queued on the card while the previous batch's
            # copy and the CPU metrics run: at most two batches in flight.
            for inp_dev, gt, names, n_act in staged_batches():
                with profile_trace():
                    out = sampler(inp_dev, generator)
                inflight.append((out, gt, names, n_act))
                while len(inflight) >= 2:
                    drain_one()
            while inflight:
                drain_one()
            sample_wall = time.time() - t0  # last sampled batch fetched
            for f in futs:
                row = f.result()
                for k, v in row.items():
                    sums[k] += v
        finally:
            pool.shutdown()
        time_cost = time.time() - t0
        res = {k: v / max(n, 1) for k, v in sums.items()}
        res["sample_wall_s"] = sample_wall
        res["fetch_block_s"] = fetch_block_s
        if stream is not None:
            res["fid_block_s"] = fid_block_s
        res["fid"] = stream.compute() if (stream and n) else float("nan")
        if fid_model is not None:
            # 1.0 = Inception-weights FID; 0.0 = He-rescaled random-feature
            # FID (self-consistent only, metrics/fid.py).
            res["fid_pretrained"] = 1.0 if fid_model.pretrained else 0.0
        res["n_images"] = n
        res["time_cost"] = time_cost
        results[domain] = res

        report_dir = os.path.join(config.output_path, "result",
                                  _dataset_name(config, domain))
        os.makedirs(report_dir, exist_ok=True)
        with open(os.path.join(report_dir, "res.txt"), "a") as f:
            f.write(f"split={split} n={n} " + " ".join(
                f"{k}={v:.4f}" for k, v in res.items()
                if isinstance(v, float)) + "\n")
    return results

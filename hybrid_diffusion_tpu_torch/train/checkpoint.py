"""Full-state checkpoints with stage-encoded names.

Counterpart of `hybrid_diffusion_tpu/train/checkpoint.py` (:20-319), with
the same names (`checkpoint_name`), metadata sidecar (`hdt_metadata.json`)
and decisions: the evidence-based choice between EMA and raw parameters
(`choose_subtree_from_evidence`), restore of parameters only, of a part, or
of the full state, never-clobber names, and `find_latest_checkpoint`, which
skips uncommitted saves.

The format is the port's own: a directory `ckpt_{epoch}_{stage}_{datasets}`
holding `state.pt`, one `torch.save` of

  - "params": the model's state_dict (fp32),
  - "optimizer": AdamW's state_dict (both moments and its step count),
  - "step": the train state's update count, with "mini_step" and
    "acc_grads" under grad_accum > 1,
  - "ema_params" when the state keeps an EMA,
  - "generator": the training loop's torch.Generator state,

beside `hdt_metadata.json`. A save is written into a temporary directory
(`<name>.tmp-<pid>`) and renamed to its name when complete, so a directory
with a checkpoint's name is always whole. It does not read orbax
checkpoints: the flat params npz (`utils/params_io.py`) is the bridge
between the two packages.

With `block=False` a save returns once the tensors are copied off the card;
a background thread writes them. `wait_for_checkpoints()` joins it.
"""

from __future__ import annotations

import glob
import json
import math
import os
import threading
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"
META_FILE = "hdt_metadata.json"
_TMP_MARK = ".tmp-"


def checkpoint_name(epoch: int, stage: str, datasets: str) -> str:
    return f"ckpt_{epoch}_{stage}_{datasets}"


def _unique_path(path: str) -> str:
    """Never clobber a checkpoint: a second save of one name gets `-2`,
    `-3`, …; `find_latest_checkpoint` resolves by mtime and
    `find_checkpoint` by the `ckpt_{epoch}_*` prefix, so both still find
    it."""
    if not os.path.exists(path):
        return path
    n = 2
    while os.path.exists(f"{path}-{n}"):
        n += 1
    return f"{path}-{n}"


def _to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor on the CPU (nested dicts, lists)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_payload(state, generator: Optional[torch.Generator] = None) -> dict:
    """The train state (and the loop's generator) as host tensors."""
    payload = {
        "params": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "mini_step": state.mini_step,
    }
    if state.acc_grads is not None:
        payload["acc_grads"] = state.acc_grads
    if state.ema_params is not None:
        payload["ema_params"] = state.ema_params
    if generator is not None:
        payload["generator"] = generator.get_state()
    return _to_host(payload)


# One background save at a time: its thread and the error it raised.
_ASYNC: dict = {"thread": None, "error": None}


def wait_for_checkpoints() -> None:
    """Block until the background save has committed; raise its error."""
    thread = _ASYNC["thread"]
    if thread is not None:
        thread.join()
        _ASYNC["thread"] = None
    error, _ASYNC["error"] = _ASYNC["error"], None
    if error is not None:
        raise error


def _write(path: str, payload: dict, meta: dict) -> None:
    tmp = f"{path}{_TMP_MARK}{os.getpid()}"
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump(meta, f)
    # Fails when another run took the name meanwhile: never clobber.
    os.rename(tmp, path)


def save_checkpoint(
    directory: str,
    epoch: int,
    stage: str,
    datasets: str,
    state: Any,
    metadata: Optional[dict] = None,
    block: bool = True,
    generator: Optional[torch.Generator] = None,
) -> str:
    """Save the full train state under a stage-encoded directory name;
    returns the path.

    block=False returns as soon as the tensors are on the host and lets
    the disk write overlap the following steps; call
    `wait_for_checkpoints()` before relying on the files."""
    wait_for_checkpoints()  # one save in flight at a time
    path = _unique_path(os.path.abspath(
        os.path.join(directory, checkpoint_name(epoch, stage, datasets))))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = state_payload(state, generator)
    has_ema = state.ema_params is not None
    meta = dict(metadata or {})
    meta["has_ema"] = has_ema
    meta.setdefault("step", int(state.step))
    if has_ema:
        meta.setdefault("ema_decay", float(state.ema_decay))
    if block:
        _write(path, payload, meta)
        return path

    def run():
        try:
            _write(path, payload, meta)
        except BaseException as e:  # raised by wait_for_checkpoints
            _ASYNC["error"] = e

    _ASYNC["thread"] = threading.Thread(target=run, daemon=False)
    _ASYNC["thread"].start()
    return path


def load_metadata(path: str) -> dict:
    """The hdt_metadata.json sidecar contents ({} when absent/corrupt)."""
    meta_file = os.path.join(os.path.abspath(path), META_FILE)
    if os.path.isfile(meta_file):
        try:
            with open(meta_file) as f:
                return dict(json.load(f))
        except (OSError, ValueError):
            pass
    return {}


def ema_init_mass(metadata: dict) -> Optional[float]:
    """decay^step: the weight the random init still carries inside the EMA.
    None when the sidecar lacks the step or ema_decay fields."""
    step, decay = metadata.get("step"), metadata.get("ema_decay")
    if step is None or not decay:
        return None
    return math.exp(int(step) * math.log(float(decay)))


# Above this much residual random-init mass the EMA is worse than the raw
# params (the JAX package measured 20-45% init mass at 4.4 dB against the
# same step's raw 9.2-10.5 dB).
EMA_INIT_MASS_THRESHOLD = 0.05


def choose_subtree_from_evidence(
    has_ema: bool,
    step: Optional[int] = None,
    ema_decay: Optional[float] = None,
    probe: Optional[dict] = None,
) -> tuple:
    """('ema_params'|'params', reason): the subtree-selection policy shared
    by the training export and eval-time restore. The --eval_every probe's
    raw-vs-EMA PSNR beats the init-mass proxy."""
    if not has_ema:
        return "params", "no EMA in checkpoint"
    probe = probe or {}
    if "psnr_ema" in probe and "psnr" in probe:
        if probe["psnr_ema"] < probe["psnr"]:
            return ("params",
                    f"probe at step {probe.get('step')}: EMA "
                    f"{probe['psnr_ema']} dB < raw {probe['psnr']} dB")
        return ("ema_params",
                f"probe at step {probe.get('step')}: EMA "
                f"{probe['psnr_ema']} dB >= raw {probe['psnr']} dB")
    mass = ema_init_mass({"step": step, "ema_decay": ema_decay})
    if mass is None:
        return ("ema_params",
                "EMA present, maturity unknown (legacy sidecar) — "
                "verify with an eval before shipping")
    if mass > EMA_INIT_MASS_THRESHOLD:
        return ("params",
                f"EMA immature ({mass:.1%} random-init mass) — "
                "falling back to raw params")
    return "ema_params", f"EMA mature ({mass:.2e} residual init mass)"


def _load_payload(path: str) -> dict:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def checkpoint_has_ema(path: str) -> bool:
    """True when the checkpoint holds `ema_params` (the sidecar says, or
    else the payload)."""
    meta = load_metadata(path)
    if "has_ema" in meta:
        return bool(meta["has_ema"])
    try:
        return "ema_params" in _load_payload(path)
    except (OSError, RuntimeError):
        return False


def choose_restore_subtree(path: str) -> tuple:
    """('ema_params'|'params', reason) — which subtree eval should load."""
    if not checkpoint_has_ema(path):
        return "params", "no EMA in checkpoint"
    meta = load_metadata(path)
    return choose_subtree_from_evidence(
        True, meta.get("step"), meta.get("ema_decay"), meta.get("probe"))


def restore_partial(path: str, keys) -> dict:
    """{key: the saved entry} for the requested top-level keys that the
    checkpoint holds (e.g. ("params", "ema_params"))."""
    payload = _load_payload(path)
    return {k: payload[k] for k in keys if k in payload}


def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load parameters only into `model` (eval load, transfer learning):
    from a checkpoint directory (EMA or raw, by `choose_restore_subtree`),
    or from a flat params npz."""
    path = os.path.abspath(path)
    if path.endswith(".npz"):
        from ..weights import load_npz_state_dict

        model.load_state_dict(load_npz_state_dict(path), strict=True)
        return model
    subtree, reason = choose_restore_subtree(path)
    print(f"[restore_params] using {subtree}: {reason}")
    saved = restore_partial(path, (subtree, "params"))
    sd = dict(saved["params"])
    if subtree == "ema_params":
        sd.update(saved["ema_params"])
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def restore_state(path: str, state: Any,
                  generator: Optional[torch.Generator] = None) -> Any:
    """Restore the full train state in place (resume mid-schedule): the
    parameters, AdamW's moments and count, the update step, the running
    mean under grad_accum, the EMA when both keep one, and `generator`."""
    payload = _load_payload(path)
    state.model.load_state_dict(payload["params"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.mini_step = int(payload.get("mini_step", 0))
    if state.acc_grads is not None and "acc_grads" in payload:
        for name, acc in state.acc_grads.items():
            acc.copy_(payload["acc_grads"][name])
    if state.ema_params is not None and "ema_params" in payload:
        for name, e in state.ema_params.items():
            e.copy_(payload["ema_params"][name])
    if generator is not None and "generator" in payload:
        generator.set_state(payload["generator"])
    return state


def _is_committed_checkpoint(path: str) -> bool:
    """A whole checkpoint directory, not a save still in its temporary
    directory (or left there by a kill mid-save)."""
    return os.path.isdir(path) and _TMP_MARK not in os.path.basename(path)


def find_latest_checkpoint(directory: str) -> Optional[str]:
    """Newest committed ckpt_* directory under `directory` (`--resume_from
    auto`)."""
    pattern = os.path.join(os.path.abspath(directory), "ckpt_*")
    hits = [p for p in glob.glob(pattern) if _is_committed_checkpoint(p)]
    return max(hits, key=os.path.getmtime) if hits else None


def find_checkpoint(directory: str, epoch: int) -> Optional[str]:
    """The newest committed `ckpt_{epoch}_*` directory under `directory`
    (the reference's eval flows select checkpoints by epoch), or None."""
    pattern = os.path.join(os.path.abspath(directory), f"ckpt_{epoch}_*")
    hits = [p for p in glob.glob(pattern) if _is_committed_checkpoint(p)]
    return max(hits, key=os.path.getmtime) if hits else None

"""Metrics logging: console (tqdm postfix) + optional wandb.

Counterpart of `hybrid_diffusion_tpu/train/logging.py` (:15-63), the same
`log`/`alert`/`finish` and prefixes. `log` turns each value into a float,
which for a device scalar waits for the card: the training loop calls it
only where the JAX loop syncs (every `log_every` steps and once an epoch).

Reference observability (SURVEY.md §C10): wandb init from Main.py:78-93,
per-step nested dicts {"Train {stage}": {...}} with None-safe guards
(rotinas.py:450-485), checkpoint alerts (rotinas.py:723-728), tqdm postfix
console telemetry. wandb is not installed in every environment — all wandb
calls are no-ops unless the package imports and the run is enabled.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional


class MetricsLogger:
    def __init__(self, enabled_wandb: bool = False, project: str = "",
                 run_name: str = "", config: Optional[dict] = None,
                 tags: Optional[list] = None, group: str = "HybridDiffusion"):
        self._wandb = None
        if enabled_wandb:
            try:
                import wandb

                # Token-file login (Main.py:78-93 reads wandb_token.txt,
                # gitignored). Override path via HDT_WANDB_TOKEN_FILE.
                import os

                token_file = os.environ.get("HDT_WANDB_TOKEN_FILE",
                                            "wandb_token.txt")
                if os.path.isfile(token_file):
                    with open(token_file) as f:
                        wandb.login(key=f.read().strip())
                wandb.init(project=project or "hybrid-diffusion-tpu",
                           name=run_name or None, config=config or {},
                           tags=tags or [], group=group, job_type="train")
                self._wandb = wandb
            except Exception as e:  # missing package / no token: degrade
                print(f"[logging] wandb disabled: {e}")

    def log(self, metrics: Mapping[str, Any], step: Optional[int] = None,
            prefix: str = "") -> dict:
        """Log scalars; returns the float-safe dict (for tqdm postfix)."""
        safe = {}
        for k, v in metrics.items():
            try:
                safe[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._wandb is not None:
            payload = {f"{prefix}{k}": v for k, v in safe.items()}
            self._wandb.log(payload, step=step)
        return safe

    def alert(self, title: str, text: str) -> None:
        if self._wandb is not None:
            try:
                self._wandb.alert(title=title, text=text)
            except Exception:
                pass

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()

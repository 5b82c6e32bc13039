"""CFG subsystem CLI: `python -m hybrid_diffusion_tpu_torch.cfg.cli --state
train|eval`.

Counterpart of `hybrid_diffusion_tpu/cfg/cli.py`: one flag per CFGConfig
field, with the same names and defaults, plus `--device` ("cuda" unless
`--device cpu` is given).
"""

from __future__ import annotations

import argparse
import dataclasses
import pprint
import sys

from .train import CFGConfig, evaluate_cfg, train_cfg


def parse_cfg_config(argv=None) -> CFGConfig:
    defaults = CFGConfig()
    p = argparse.ArgumentParser(description="CFG CIFAR-10 diffusion (GPU)")
    for f in dataclasses.fields(CFGConfig):
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument(f"--{f.name}", dest=f.name,
                           action=argparse.BooleanOptionalAction,
                           default=default)
        elif f.name == "channel_mult":
            p.add_argument("--channel_mult", type=int, nargs="+",
                           default=list(default))
        elif default is None:
            p.add_argument(f"--{f.name}", type=str, default=None)
        else:
            p.add_argument(f"--{f.name}", type=type(default), default=default)
    args = p.parse_args(argv)
    return CFGConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(CFGConfig)})


def main(argv=None) -> int:
    config = parse_cfg_config(argv)
    print("\nFinal configuration:")
    pprint.pprint(dataclasses.asdict(config))
    if config.state == "train":
        train_cfg(config)
    elif config.state == "eval":
        evaluate_cfg(config)
    else:
        print("Invalid state. Use 'train' or 'eval'.")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())

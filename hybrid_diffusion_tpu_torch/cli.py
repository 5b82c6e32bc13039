"""CLI entry point — `python -m hybrid_diffusion_tpu_torch.cli --state train …`.

Counterpart of `hybrid_diffusion_tpu/cli.py` (:15-42), the same dispatch:
train | eval (val split) | test (test split; `inference` is an alias) |
enhance (with --inference_image). Runs on the card unless given
`--device cpu`.
"""

from __future__ import annotations

import sys

from .config import parse_config


def main(argv=None) -> int:
    config = parse_config(argv)
    config.pprint()

    from .train.loop import enhance_image, evaluate, train

    if config.state == "train":
        print("Training model")
        train(config)
    elif config.state == "enhance" or (
        config.inference_image and config.state in ("eval", "test")
    ):
        print("Enhancing single image")
        enhance_image(config)
    elif config.state == "eval":
        print("Evaluating model (val split)")
        results = evaluate(config, split="val")
        print(results)
    elif config.state == "test":
        print("Testing model (test split)")
        results = evaluate(config, split="test")
        print(results)
    else:
        print("Invalid state. Use 'train', 'eval', 'test' (alias "
              "'inference'), or 'enhance' with --inference_image.")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())

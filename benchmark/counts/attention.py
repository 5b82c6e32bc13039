"""Operations and bytes of the attention calls of a model call, from the
(B, N, heads, d) shapes that the plain reference's forward visits.

A forward counts 4·B·h·N²·d operations (two products); a backward the
vjp's four products, 8·B·h·N²·d, not the recomputation of the scores.
Bytes count each input read once and each output written once: a forward
reads q, k, v and writes out; a backward reads q, k, v, out, dout and the
fp32 log-sum-exp (B·h·N) and writes dq, dk, dv. A launch's bound is the
larger of its operations at the peak rate and its bytes at the peak
bandwidth; there is no term for the exponentials.
"""

from __future__ import annotations

import functools
import json

from benchmark.counts.flops import model_inputs
from benchmark.reference import layers, unet

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@functools.lru_cache(maxsize=None)
def _shapes(model_json: str) -> tuple:
    model_cfg = json.loads(model_json)
    model = unet.build(model_cfg, layers.FP32, "meta")
    layers.attention_calls = []
    try:
        model(*model_inputs(model_cfg, 1))
        return tuple(layers.attention_calls)
    finally:
        layers.attention_calls = None


def shapes(model_cfg: dict, batch: int) -> list[tuple]:
    """(B, N, heads, d) of each attention call of one forward at `batch`."""
    return [(batch,) + s[1:] for s in
            _shapes(json.dumps(model_cfg, sort_keys=True))]


def ops_bytes(shape: tuple, dtype: str, backward: bool) -> tuple[float, float]:
    B, N, h, d = shape
    e = BYTES[dtype]
    if backward:
        return 8.0 * B * h * N * N * d, (8 * B * N * h * d * e + 4 * B * h * N)
    return 4.0 * B * h * N * N * d, 4 * B * N * h * d * e


def bound_s(model_cfg: dict, batch: int, dtype: str, backward: bool,
            peaks: dict) -> float:
    """The least time of one model call's attention launches (forward, or
    with `backward` forward and backward) at the card's peaks."""
    total = 0.0
    for s in shapes(model_cfg, batch):
        for bwd in ((False, True) if backward else (False,)):
            ops, nbytes = ops_bytes(s, dtype, bwd)
            total += max(ops / peaks["flops_per_s"][dtype],
                         nbytes / peaks["bytes_per_s"])
    return total

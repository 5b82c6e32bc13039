"""The port's bench (`hybrid_diffusion_tpu_torch/bench.py`) on the CPU.

Each mode, with BENCH_QUICK=1 and BENCH_DEVICE=cpu, prints one JSON line a
result with exactly the four keys of the JAX package's bench.py, a finite
positive value, and its metric in bench.py's format (the attention arms
named plain and kernel where JAX's are xla and pallas, the train tag
attn=kernel), plus a `# record` line on stderr. The sampling run is cut to
2 DDIM steps and 1 timed run and the train run to 1 timed step (the quick
sizes, 64² batch 4, stay), so that the file stays within ~30 s on one
torch thread.

The bench's model is held against the JAX bench's (bench.py:256-281:
DynamicUNet with dtype and norm_dtype bf16, its parameter tree cast to
bf16) on the same numpy-seeded weights at 32²: every module the two share
by name returns the same dtype (every GroupNorm bf16 in both), the port's
GroupNorm with a bf16 output is flax's GroupNorm(dtype=bf16) to one bf16
ulp (measured: equal but for one element in 8192, one ulp apart), and the
outputs agree within 2^-5 of max|ε| (measured 1.33e-2, 1.33e-2, 1.67e-2 at
seeds 0-2; bf16 rounds at other places in the two frameworks, and the port
with fp32 GroupNorm outputs lands as close, 1.1e-2 to 1.6e-2, which is why
the dtypes are checked module by module).

The one-time bf16 cast of the weights (`cast_weights_once`, as bench.py
casts its parameter tree) is held against the fp32-master model at bf16
tolerance: both compute in bf16; the cast model's weights are the masters
rounded to bf16 once, where the masters are rounded at every call, so
the two differ only where a layer that computes in fp32 (the fp32 tail
conv) now sees rounded weights; the GroupNorms, whose outputs are bf16,
take bf16 affine weights in both. Bound: 2^-6 of max|ε| (four bf16
half-ulps, 2^-9 each, through the network), measured 5.4e-3 at seed 0
(3.9e-3 and 3.5e-3 at seeds 1 and 2; 32², batch 2).
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from hybrid_diffusion_tpu_torch import bench

KEYS = {"metric", "value", "unit", "vs_baseline"}
CAST_RTOL = 2.0 ** -6
JAX_BENCH_RTOL = 2.0 ** -5


def run_bench(monkeypatch, capsys, **env):
    """bench.main() under BENCH_QUICK=1 BENCH_DEVICE=cpu and `env`;
    returns (JSON lines of stdout, `# record` dicts of stderr)."""
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_QUICK", "1")
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bench.main()
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    records = [json.loads(line[len("# record "):]) for line in
               err.splitlines() if line.startswith("# record ")]
    return lines, records


def check_line(line, metric, unit):
    assert set(line) == KEYS
    assert line["metric"] == metric
    assert line["unit"] == unit
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert math.isfinite(line["vs_baseline"]) and line["vs_baseline"] > 0


def test_sampling_mode_prints_bench_py_line(monkeypatch, capsys):
    lines, records = run_bench(monkeypatch, capsys, BENCH_STEPS="2",
                               BENCH_REPS="1")
    assert len(lines) == 1
    # bench.py:310-319 at the quick sizes (batch 4, 64²).
    check_line(lines[0], "images/sec/chip 64x64 DDIM-2 sampling "
               "(batch 4, bf16)", "images/sec")
    assert lines[0]["vs_baseline"] == lines[0]["value"]   # ÷ 1.0 img/s
    (rec,) = records
    assert rec["device"] == "cpu" and rec["weights"] == "bf16 once"
    assert rec["norm_out"] == "bf16"
    assert rec["attention_launches"] == 0     # no kernel on the CPU
    assert rec["unet_call_device_ms"] is None


@pytest.mark.parametrize("env,tag", [
    ({}, "loss=composite routing=on attn=kernel"),
    ({"BENCH_LOSS": "mse", "BENCH_ROUTING": "0", "BENCH_REMAT": "1",
      "BENCH_GRAD_ONLY": "1"},
     "loss=mse routing=off attn=kernel remat grad-only"),
])
def test_train_mode_prints_bench_py_line(monkeypatch, capsys, env, tag):
    lines, records = run_bench(monkeypatch, capsys, BENCH_MODE="train",
                               BENCH_REPS="1", **env)
    assert len(lines) == 1
    # bench.py:148-153: batch 4, 64² when quick.
    check_line(lines[0], f"train steps/sec 64x64 batch 4 ({tag})",
               "steps/sec")
    (rec,) = records
    assert math.isfinite(rec["last_loss"])


def test_attn_mode_prints_a_line_per_arm_and_pass(monkeypatch, capsys):
    lines, records = run_bench(monkeypatch, capsys, BENCH_MODE="attn")
    # bench.py:222-228 at the quick shape (B 2, N 64, 8 heads of 32).
    want = [f"attention {p} us/call {arm} (B=2 N=64 h=8 d=32, bf16)"
            for arm in ("plain", "kernel") for p in ("fwd", "fwd+bwd")]
    assert [line["metric"] for line in lines] == want
    for line, metric in zip(lines, want):
        check_line(line, metric, "us")
    assert len(records) == 4
    assert [(r["arm"], r["pass_"]) for r in records] == [
        (arm, p) for arm in ("plain", "kernel") for p in ("fwd", "fwd+bwd")]


def test_unknown_mode_and_missing_card_refuse(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        run_bench(monkeypatch, capsys, BENCH_MODE="serve")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_bench(monkeypatch, capsys, BENCH_DEVICE="cuda")


def test_cast_weights_once_matches_the_fp32_masters():
    masters = bench.bench_model(quick=True, dropout=0.0).eval()
    # Unit-gain weights (the init shrinks the tail conv to ~1e-5, which
    # would hide the rest of the network).
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in masters.parameters():
            w = torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32))
            p.copy_(w / math.sqrt(w[0].numel()) if w.ndim > 1 else 0.1 * w)
    cast = bench.cast_weights_once(copy.deepcopy(masters))
    # Layers that compute in bf16 hold bf16 weights; the others hold the
    # bf16-rounded masters in fp32.
    m_params = dict(masters.named_parameters())
    for name, p in cast.named_parameters():
        rounded = m_params[name].detach().to(torch.bfloat16)
        assert torch.equal(p, rounded.to(p.dtype)), name
    assert cast.tail_conv.weight.dtype == torch.float32
    assert cast.tail_norm.weight.dtype == torch.float32
    assert cast.head.weight.dtype == torch.bfloat16
    assert cast.downsample_0.k5.dtype == torch.bfloat16
    assert cast.middle_0.attn.in_proj.weight.dtype == torch.bfloat16
    assert cast.time_embedding.table.dtype == torch.bfloat16

    x6 = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 6)).astype(np.float32))
    t = torch.tensor([3, 700])
    with torch.no_grad():
        want = masters(x6, t)
        got = cast(x6, t)
    assert got.dtype == want.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= CAST_RTOL, err


def jax_bench_model():
    """The JAX bench's quick U-Net (bench.py:256-270) and its param
    template at 32²."""
    import jax
    import jax.numpy as jnp

    from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet

    jm = JaxUNet(T=1000, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 dropout=0.0, dtype=jnp.bfloat16, norm_dtype=jnp.bfloat16)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 6)),
                              jnp.zeros((1,), jnp.int32))
    return jm, template


@pytest.mark.parametrize("seed", [0, 1])
def test_bench_model_is_the_jax_bench_model(seed):
    import jax
    import jax.numpy as jnp

    from _torch_parity import random_params, rel_err, to_port

    jm, template = jax_bench_model()
    params = random_params(template, seed)
    port = bench.bench_model(quick=True, dropout=0.0).eval()
    port.load_state_dict(to_port(params), strict=True)
    bench.cast_weights_once(port)
    # bench.py:278: every fp32 leaf to bf16 once.
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        params)
    rng = np.random.default_rng(seed)
    x6 = rng.uniform(-1, 1, (2, 32, 32, 6)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    want, state = jax.jit(lambda p, x, tt: jm.apply(
        p, x, tt, capture_intermediates=True, mutable=["intermediates"]))(
        params, jnp.asarray(x6), jnp.asarray(t))
    jax_dtypes = {
        ".".join(str(k.key) for k in path[:-2]): leaf.dtype
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            state["intermediates"])[0]
        if str(path[-2].key) == "__call__"}
    port_dtypes = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: port_dtypes.__setitem__(
            name, out.dtype))
        for name, m in port.named_modules() if name]
    with torch.no_grad():
        got = port(torch.from_numpy(x6), torch.from_numpy(t).long())
    for h in hooks:
        h.remove()
    shared = sorted(set(jax_dtypes) & set(port_dtypes))
    norms = [n for n in shared if n.rsplit(".", 1)[-1] in
             ("norm1", "norm2", "tail_norm")]
    # 1 tail norm + 2 a ResBlock (2 down, 4 middle, 2 up).
    assert len(norms) == 1 + 2 * 8 and len(shared) > len(norms)
    for name in shared:
        assert str(port_dtypes[name]).split(".")[-1] == str(
            jax_dtypes[name]), name
    assert all(port_dtypes[n] == torch.bfloat16 for n in norms)
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and np.abs(want).max() > 0.1
    err = rel_err(got.numpy(), want)
    assert err <= JAX_BENCH_RTOL, err


def test_group_norm_bf16_output_is_flax_group_norm():
    import flax.linen as fnn
    import jax.numpy as jnp

    from hybrid_diffusion_tpu_torch.models.layers import GroupNorm32

    rng = np.random.default_rng(0)
    x = jnp.asarray(3 * rng.standard_normal((2, 8, 8, 64)) + 0.5,
                    jnp.bfloat16)
    scale = 1 + 0.1 * rng.standard_normal(64)
    bias = 0.1 * rng.standard_normal(64)
    want = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.bfloat16
                         ).apply({"params": {
                             "scale": jnp.asarray(scale, jnp.bfloat16),
                             "bias": jnp.asarray(bias, jnp.bfloat16)}}, x)
    gn = GroupNorm32(64, torch.bfloat16)
    with torch.no_grad():
        gn.weight.copy_(torch.tensor(scale).bfloat16().float())
        gn.bias.copy_(torch.tensor(bias).bfloat16().float())
        got = gn(torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                 .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    assert np.all(np.abs(got.float().numpy() - want)
                  <= 2.0 ** -7 * np.abs(want))

"""Weights carried from the JAX package into the port, and the port's hygiene:
no JAX below it, and entry points that run on the card unless asked not to.
"""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu_torch.config import Config, flagship_config
from hybrid_diffusion_tpu_torch.ops import attention as port_attention
from hybrid_diffusion_tpu_torch.serve import Enhancer
from hybrid_diffusion_tpu_torch.train.loop import build_model
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import (
    load_npz_state_dict,
    state_dict_from_flat,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "hybrid_diffusion_tpu_torch"
NPZS = [REPO / "docs" / "assets" / "flagship256_fp16.npz",
        REPO / "docs" / "assets" / "flagship256_r5_fp16.npz"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
             "hybrid_diffusion_tpu")


@pytest.mark.parametrize("npz", NPZS, ids=["base50k", "r5ext"])
def test_committed_flagship_npz_loads_strict_into_port(npz):
    """Both committed flagship files fill the port's flagship model with no
    missing or extra key, as fp32 master weights, the kernels transposed."""
    model = build_model(flagship_config())
    state = load_npz_state_dict(npz)
    model.load_state_dict(state, strict=True)
    sd = model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    with np.load(npz) as z:
        assert len(z.files) == len(state) == 319
        head = z["params/head/kernel"]                       # HWIO
        in_proj = z["params/middle_0/attn/in_proj/kernel"]   # (C, 3C)
        kt = z["params/upsample_1/kt"]
        scale = z["params/tail_norm/scale"]
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  head.astype(np.float32).transpose(3, 2, 0, 1))
    assert in_proj.shape == (256, 768)
    np.testing.assert_array_equal(sd["middle_0.attn.in_proj.weight"].numpy(),
                                  in_proj.astype(np.float32).T)
    np.testing.assert_array_equal(sd["upsample_1.kt"].numpy(),
                                  kt.astype(np.float32).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["tail_norm.weight"].numpy(),
                                  scale.astype(np.float32))


def test_jax_init_params_map_into_port():
    """A JAX-initialised tree at ch 32, mult (1, 2), 1 res block fills the
    port's model with every key, each value carried exactly."""
    jm = JaxUNet(T=100, ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)),
                              jnp.zeros((1,), jnp.int32))
    model = build_model(Config(T=100, channel=32, channel_mult=(1, 2),
                               num_res_blocks=1, bf16=False))
    state = state_dict_from_flat(flatten_params(params["params"]))
    model.load_state_dict(state, strict=True)
    sd = model.state_dict()
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params["params"]))
    assert len(flat) == len(sd)
    np.testing.assert_array_equal(
        sd["time_embedding.table"].numpy(),
        flat["time_embedding/table"])
    np.testing.assert_array_equal(
        sd["downsample_0.k5"].numpy(),
        flat["downsample_0/k5"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["middle_0.attn.out_proj.weight"].numpy(),
        flat["middle_0/attn/out_proj/kernel"].T)


def test_unknown_parameter_is_refused():
    with pytest.raises(KeyError, match="no mapping"):
        state_dict_from_flat({"params/x/gamma": np.ones(3)})


# ---------------------------------------------------------------- hygiene


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        bad = _imported_roots(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_port_runs_with_jax_blocked():
    """A fresh interpreter where importing JAX or the JAX package fails
    imports every module of the port and runs the 32² path on the CPU."""
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import numpy as np, torch
import hybrid_diffusion_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, "hybrid_diffusion_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.train.loop import build_model, make_sampler
torch.manual_seed(0)
cfg = Config(T=100, channel=32, channel_mult=(1, 2), num_res_blocks=1,
             img_size=32, bf16=False, sampler="dpm++2m", ddim_step=3)
model = build_model(cfg).eval()
cond = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))
out = make_sampler(cfg, model, quantize_uint8=True)(cond, torch.Generator().manual_seed(0))
assert out.shape == (1, 32, 32, 3) and out.dtype == torch.uint8, (out.shape, out.dtype)
loaded = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r} and sys.modules[n] is not None)
assert not loaded, loaded
print(len(mods))
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_enhancer_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    assert inspect.signature(Enhancer).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Enhancer(flagship_config(), NPZS[1])


@pytest.fixture()
def small_npz(tmp_path):
    """A flat params npz for a small model, from numpy-seeded weights."""
    rng = np.random.default_rng(0)
    jm = JaxUNet(T=100, ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 6)),
                              jnp.zeros((1,), jnp.int32))
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path):
            (0.1 * rng.standard_normal(t.shape)).astype(np.float16)
        for path, t in jax.tree_util.tree_flatten_with_path(template)[0]}
    path = tmp_path / "small.npz"
    np.savez_compressed(path, **flat)
    return path


def test_enhancer_on_cpu_pads_short_batches(small_npz):
    cfg = Config(T=100, channel=32, channel_mult=(1, 2), num_res_blocks=1,
                 img_size=16, bf16=False, sampler="dpm++2m", ddim_step=2)
    port_attention.reset_launch_count()
    enh = Enhancer(cfg, small_npz, max_batch=2, device="cpu")
    assert enh.device_calls == 1                       # the warm-up
    rng = np.random.default_rng(1)
    images = list(rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8))
    outs = enh.enhance(images)
    assert enh.device_calls == 3                       # 2 + 1 padded to 2
    assert [o.shape for o in outs] == [(16, 16, 3)] * 3
    assert all(o.dtype == np.uint8 for o in outs)
    assert enh.enhance([]) == []
    assert port_attention.launch_count == 0            # CPU: plain version
    with pytest.raises(ValueError, match="data slice"):
        enh.enhance([np.zeros((8, 8, 3), np.uint8)])

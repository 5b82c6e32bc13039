"""The port's demos against the JAX package's scripts (CPU).

- demo_cfg's numpy helpers (`class_templates`, `template_accuracy`) are
  copies of the JAX script's: bit-equal on seeded inputs.
- A cfg_params.npz in the JAX layout (a JAX CFGUNet, ch 32, 16², on
  unit-gain weights, flattened as the JAX demo writes it), read by the
  port's regen_cfg_grids, gives JAX's guided ε at w 1.8 within
  (1 + 2w)·1e-5 of max|ε|, tests/test_torch_cfg.py's bound for the guided
  ε (fp32: each call within 1e-5, the mix scales it by up to 1 + 2w);
  measured 2.6e-5 here, and from 1.45e-5 to 4.19e-5 over weight seeds 3-5
  × input seeds 4-6, so a flat 1e-5 is below what fp32 reaches here.
- Each port demo's JSON has the same key tree as the JAX demo's, with
  `train`/`evaluate` (demo_e2e, demo_staged) or `train_cfg` and the
  sampler (demo_cfg, regen_cfg_grids) stubbed in both, the same argv.
- Each port demo runs end to end, unstubbed, at the smallest size on the
  CPU (32², ch 32, T 20, a few steps; the CFG demo at 16², T 4): exit 0 or
  the demo's own verdict 1, a JSON of finite values; demo_cfg's
  cfg_params.npz has the JAX CFGUNet's parameter names and shapes, and
  the port's regen_cfg_grids reads it.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, random_params, rel_err  # noqa: F401
import hybrid_diffusion_tpu.cfg.sampler as jax_cfg_sampler
import hybrid_diffusion_tpu.cfg.train as jax_cfg_train
import hybrid_diffusion_tpu.train.loop as jax_loop
from hybrid_diffusion_tpu.models.cfg_unet import CFGUNet as JaxCFGUNet
import hybrid_diffusion_tpu_torch.cfg.sampler as port_cfg_sampler
import hybrid_diffusion_tpu_torch.cfg.train as port_cfg_train
import hybrid_diffusion_tpu_torch.train.loop as port_loop
from hybrid_diffusion_tpu_torch.scripts import (demo_cfg, demo_e2e,
                                                demo_staged, regen_cfg_grids)
from hybrid_diffusion_tpu_torch.weights import flat_from_state_dict

REPO = Path(__file__).resolve().parent.parent
# tests/test_torch_cfg.py's small CFGUNet, fp32, at T 4.
SMALL_CFG = dict(T=4, ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0)
# The CFG demos' smallest run: CFGConfig's mult (1, 2, 2, 2) and 2 res
# blocks (regen_cfg_grids has no flags for them) at ch 32, 16², T 4.
CFG_ARGV = ["--channel", "32", "--T", "4", "--img_size", "16", "--nrow", "1",
            "--ws", "0,1.8"]
E2E_ARGV = ["--steps", "4", "--size", "32", "--batch", "4", "--channel", "32",
            "--T", "20", "--ddim_steps", "3"]
STAGED_ARGV = ["--steps_per_stage", "1", "--size", "32", "--batch", "4",
               "--channel", "32", "--channel_mult", "1", "2", "--T", "20",
               "--synthetic_length", "8", "--ddim_steps", "3"]


def jax_script(name):
    """The JAX package's scripts/<name>.py as a module (its main unrun);
    scripts/ on sys.path while it loads (regen_cfg_grids imports
    demo_cfg from there)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return mod


def run_main(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["prog"] + [str(a) for a in argv])
    try:
        return main()
    except SystemExit as e:
        return e.code


def key_tree(obj):
    """The nested keys of a JSON value (lists element by element)."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [key_tree(v) for v in obj]
    return None


def finite_numbers(obj):
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def test_template_helpers_are_bit_equal_to_jax():
    jax_mod = jax_script("demo_cfg")
    for size in (8, 16, 32):
        want = jax_mod.class_templates(size)
        got = demo_cfg.class_templates(size)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    rng = np.random.default_rng(3)
    templates = jax_mod.class_templates(16)
    imgs = rng.integers(0, 256, (40, 16, 16, 3), dtype=np.uint8)
    imgs[:10] = templates[rng.integers(0, 10, 10)].astype(np.uint8)
    labels = rng.integers(0, 10, 40)
    assert demo_cfg.template_accuracy(imgs, labels, templates) == \
        jax_mod.template_accuracy(imgs, labels, templates)


def test_regen_reads_the_jax_layout_to_jax_guided_eps(tmp_path):
    """A JAX CFGUNet (ch 32, mult (1, 2), 1 res block, T 4, 16², fp32) on
    unit-gain numpy-seeded weights (the init's 1e-5 tail would hide the
    network), written as the JAX demo writes cfg_params.npz, read by
    regen_cfg_grids.load_cfg_model. Bound: tests/test_torch_cfg.py's for
    the guided ε, (1 + 2w)·1e-5 of max|ε|, since the mix (1+w)·ε_c − w·ε_u
    scales each call's own error by up to 1 + 2w."""
    w = 1.8
    jm = JaxCFGUNet(**SMALL_CFG)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)),
                              jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1,), jnp.int32))
    params = random_params(template, seed=4)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "cfg_params.npz", **flat)
    model = regen_cfg_grids.load_cfg_model(
        str(tmp_path / "cfg_params.npz"), port_cfg_train.CFGConfig(
            T=4, channel=32, channel_mult=(1, 2), num_res_blocks=1,
            img_size=16, dropout=0.0, bf16=False, device="cpu"))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    t = np.array([1, 3, 1, 3], np.int32)
    labels = np.array([1, 4, 7, 10], np.int32)
    apply = jax.jit(jm.apply)
    want = np.asarray(jax_cfg_sampler._guided_eps(
        lambda a, b, c: apply(params, a, b, c), jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(labels), w))
    with torch.no_grad():
        got = port_cfg_sampler._guided_eps(
            model, torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(labels).long(), w).numpy()
    assert np.abs(want).max() > 0.1   # the weights reach the output
    assert rel_err(got, want) <= (1 + 2 * w) * 1e-5


# ---------------------------------------------------------------- key trees


def fake_results():
    row = dict(psnr=12.5, ssim=0.4, uiqm=2.2, uciqe=38.9, uism=8.9,
               uicm=16.9, uiconm=-0.24, uiqm_nd=3.0, sample_wall_s=1.5,
               fetch_block_s=0.1, fid=float("nan"), n_images=4,
               time_cost=1.6)
    return {"underwater": dict(row), "atmospheric": dict(row, psnr=11.5)}


def stub_loop(monkeypatch, module, loss):
    stages = [{"stage": "Atmospheric", "last_loss": loss(0.9),
               "checkpoint": "ck/a"},
              {"stage": "Underwater", "last_loss": loss(0.8),
               "checkpoint": "ck/b"}]
    monkeypatch.setattr(module, "train", lambda config, max_steps=None: {
        "steps": 4, "stages": stages, "preempted": False})
    monkeypatch.setattr(module, "evaluate", lambda config, **kw:
                        fake_results())


@pytest.mark.parametrize("name,argv", [("demo_e2e", E2E_ARGV),
                                       ("demo_staged", STAGED_ARGV)])
def test_demo_json_has_the_jax_key_tree(monkeypatch, tmp_path, name, argv):
    port = {"demo_e2e": demo_e2e, "demo_staged": demo_staged}[name]
    stub_loop(monkeypatch, jax_loop, float)
    stub_loop(monkeypatch, port_loop, torch.tensor)
    out = {}
    for side, main in (("jax", jax_script(name).main), ("port", port.main)):
        extra = ["--device", "cpu"] if side == "port" else []
        run_main(monkeypatch, main, argv + extra + [
            "--keep", tmp_path / side, "--out", tmp_path / f"{side}.json"])
        out[side] = json.loads((tmp_path / f"{side}.json").read_text())
    assert key_tree(out["port"]) == key_tree(out["jax"])
    assert out["port"]["degraded_input_baseline"] == \
        out["jax"]["degraded_input_baseline"]


def stub_cfg(monkeypatch, tmp_path):
    """train_cfg and the CFG sampler stubbed in both packages (two losses,
    parameters, zero samples); returns a cfg_params.npz of the port's
    seeded init in the JAX layout, which both regen_cfg_grids read."""
    port_params = port_cfg_train.init_cfg_model(port_cfg_train.CFGConfig(
        T=4, channel=32, img_size=16, device="cpu"), "cpu").state_dict()
    np.savez(tmp_path / "init.npz", **flat_from_state_dict(port_params))
    monkeypatch.setattr(jax_cfg_train, "train_cfg", lambda c, max_steps=None: {
        "steps": 2, "losses": [1.0, 0.5],
        "params": {"params": {"w": np.zeros(2, np.float32)}}})
    monkeypatch.setattr(port_cfg_train, "train_cfg",
                        lambda c, max_steps=None: {
                            "steps": 2, "losses": [1.0, 0.5],
                            "params": port_params})
    monkeypatch.setattr(jax_cfg_sampler, "cfg_ddpm_sample",
                        lambda fn, sched, labels, rng, image_size, w:
                        jnp.zeros((labels.shape[0], image_size, image_size,
                                   3)))
    monkeypatch.setattr(port_cfg_sampler, "cfg_ddpm_sample",
                        lambda fn, sched, labels, gen, image_size, w:
                        torch.zeros((labels.shape[0], image_size, image_size,
                                     3)))
    return tmp_path / "init.npz"


def test_cfg_demos_json_have_the_jax_key_tree(monkeypatch, tmp_path):
    params_npz = stub_cfg(monkeypatch, tmp_path)
    out = {}
    for side in ("jax", "port"):
        extra = ["--device", "cpu"] if side == "port" else []
        demo = jax_script("demo_cfg").main if side == "jax" else demo_cfg.main
        regen = (jax_script("regen_cfg_grids").main if side == "jax"
                 else regen_cfg_grids.main)
        run_main(monkeypatch, demo, CFG_ARGV + extra + [
            "--steps", "2", "--batch", "8", "--keep", tmp_path / side,
            "--out", tmp_path / f"{side}_demo.json"])
        assert run_main(monkeypatch, regen, CFG_ARGV + extra + [
            "--params", params_npz, "--keep", tmp_path / side,
            "--out", tmp_path / f"{side}_regen.json"]) == 0
        out[side] = [json.loads((tmp_path / f"{side}_{k}.json").read_text())
                     for k in ("demo", "regen")]
    for got, want in zip(out["port"], out["jax"]):
        assert key_tree(got) == key_tree(want)
    assert out["port"][0]["sweep"][0]["template_accuracy"] == \
        out["jax"][0]["sweep"][0]["template_accuracy"]


# ---------------------------------------------------------------- real runs


def test_e2e_and_staged_demos_run_on_the_cpu(monkeypatch, tmp_path):
    for name, main, argv in (("e2e", demo_e2e.main, E2E_ARGV),
                             ("staged", demo_staged.main, STAGED_ARGV)):
        out = tmp_path / f"{name}.json"
        rc = run_main(monkeypatch, main, argv + [
            "--device", "cpu", "--keep", tmp_path / name, "--out", out])
        assert rc in (0, 1), (name, rc)      # 1: the demo's own verdict
        summary = json.loads(out.read_text())
        assert finite_numbers(summary), summary
        for d in ("underwater", "atmospheric"):
            assert summary["trained"][d]["n_images"] > 0
        assert summary["train"]["steps"] >= 2


def test_cfg_demo_and_regen_run_on_the_cpu(monkeypatch, tmp_path):
    keep = tmp_path / "cfg"
    rc = run_main(monkeypatch, demo_cfg.main, CFG_ARGV + [
        "--steps", "2", "--batch", "8", "--synthetic_length", "16",
        "--device", "cpu", "--keep", keep, "--out", tmp_path / "demo.json"])
    assert rc in (0, 1)
    demo = json.loads((tmp_path / "demo.json").read_text())
    assert finite_numbers(demo) and demo["train"]["steps"] == 2
    assert [e["w"] for e in demo["sweep"]] == [0.0, 1.8]
    # cfg_params.npz in the JAX layout: the JAX CFGUNet's names and shapes.
    jax_model = jax_cfg_train.build_cfg_model(jax_cfg_train.CFGConfig(
        T=4, channel=32, img_size=16))
    template = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)),
                              jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1,), jnp.int32))
    want = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(template)[0]}
    with np.load(keep / "cfg_params.npz") as z:
        assert {k: z[k].shape for k in z.files} == want
    assert run_main(monkeypatch, regen_cfg_grids.main, CFG_ARGV + [
        "--params", keep / "cfg_params.npz", "--device", "cpu",
        "--out", tmp_path / "regen.json"]) == 0
    regen = json.loads((tmp_path / "regen.json").read_text())
    assert finite_numbers(regen) and len(regen["sweep"]) == 2
    assert (keep / "cfg_grid_w1.8.png").is_file()

"""The port's eval-side tools against the JAX package's scripts (CPU).

- eval_flagship and sweep_sampler: the JAX script is loaded from
  `scripts/` with importlib and its `evaluate` (imported inside `main` from
  `hybrid_diffusion_tpu.train.loop`) replaced by a stub; the port's
  `evaluate` by the same stub. The same argv builds equal Configs field by
  field (the port adds only `device`), with the same split, FID and image
  flags, and both write equal JSON (but for the wall-clock seconds). One
  real `--untrained` run of the port's eval_flagship at 32² gives finite
  values.
- export_params: both scripts re-export the same npz (a JAX DynamicUNet's
  parameters, ch 32, mult (1, 2), 32²) to byte-equal arrays with equal
  sidecars; a forced --subtree on an npz exits 2 in both. A port
  checkpoint with an EMA exports the subtree `choose_restore_subtree`
  picks (the EMA when mature, else the raw parameters), or the forced
  one; its fp32 export holds the EMA's arrays exactly in the JAX layout,
  and loaded into the JAX DynamicUNet gives the port model's ε within 5e-5
  of max|ε| on three inputs (each of ~20 convolutions and GroupNorms sums
  in another order in the two frameworks). Measured on these weights
  (_torch_parity.tiny_pair's seed 7) at input seeds 1-3: 1.0e-5, 4.8e-6,
  2.96e-5; over weight seeds 5-8 × input seeds 1-3 the reading ranged
  from 3.7e-6 to 2.96e-5, so 1e-5 is below what fp32 reaches here. A
  wrong subtree or layout moves ε by O(1).
- rescore_metrics: on tests/test_rescore.py's fixture (GT + uniform ±8
  noise at 32², 10 images a domain), the port's and the JAX script's JSON
  agree within 1e-4 relative (both round to 4 places: measured equal) and
  their res.txt lines have the same fields in the same order.
- make_preview_grid: pixel-equal to the JAX script's grid when the
  enhanced images are at the grid's size; within one level where they are
  resized (the port's bilinear resize against cv2's INTER_LINEAR).
"""

import dataclasses
import importlib.util
import json
import math
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (TINY, one_torch_thread, rel_err,  # noqa: F401
                           tiny_pair, to_port)
import hybrid_diffusion_tpu.train.loop as jax_loop
import hybrid_diffusion_tpu_torch.train.loop as port_loop
from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu.utils.params_io import (load_params_npz,
                                                  save_params_npz)
from hybrid_diffusion_tpu_torch.models import DynamicUNet
from hybrid_diffusion_tpu_torch.weights import flat_from_state_dict
from hybrid_diffusion_tpu_torch.scripts import (eval_flagship, export_params,
                                                make_preview_grid,
                                                rescore_metrics, sweep_sampler)

REPO = Path(__file__).resolve().parent.parent
MODEL = TINY
MODEL_ARGV = ["--T", "20", "--channel", "32", "--channel_mult", "1", "2",
              "--num_res_blocks", "1", "--size", "32"]


def jax_script(name):
    """The JAX package's scripts/<name>.py as a module (its main unrun)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(monkeypatch, main, argv):
    """main() under sys.argv = [prog] + argv; its return or exit code."""
    monkeypatch.setattr(sys, "argv", ["prog"] + [str(a) for a in argv])
    try:
        return main()
    except SystemExit as e:
        return e.code


def fake_results():
    row = dict(psnr=21.23456, ssim=0.81234, uiqm=2.2, uciqe=38.9,
               uism=8.9, uicm=16.9, uiconm=-0.24, uiqm_nd=3.0,
               sample_wall_s=1.5, fetch_block_s=0.1, fid=float("nan"),
               n_images=4, time_cost=1.6)
    return {"underwater": dict(row),
            "atmospheric": dict(row, psnr=20.5, fid=1.25)}


def stub_evaluate(monkeypatch, module, calls):
    def evaluate(config, split="test", compute_fid=True, save_images=True,
                 **kw):
        calls.append(dict(config=config, split=split, fid=compute_fid,
                          save_images=save_images))
        return fake_results()

    monkeypatch.setattr(module, "evaluate", evaluate)


def assert_same_config(jax_cfg, port_cfg):
    j, p = dataclasses.asdict(jax_cfg), dataclasses.asdict(port_cfg)
    assert p.pop("device") == "cpu"
    assert {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in j.items()} == \
        {k: (list(v) if isinstance(v, tuple) else v) for k, v in p.items()}


def without_wall(obj):
    """The summary without its wall-clock seconds."""
    if isinstance(obj, dict):
        return {k: without_wall(v) for k, v in obj.items()
                if k != "eval_wall_s"}
    if isinstance(obj, list):
        return [without_wall(v) for v in obj]
    return obj


@pytest.mark.parametrize("argv", [
    ["--ckpt", "w.npz", "--sampler", "dpm++2m", "--ddim_steps", "5"],
    ["--untrained", "--guidance", "1.5", "--use_conditioning", "--fid",
     "--save_images", "--split", "test", "--batch", "4",
     "--synthetic_length", "14"] + MODEL_ARGV,
])
def test_eval_flagship_same_config_and_json(monkeypatch, tmp_path, argv):
    jax_mod = jax_script("eval_flagship")
    jax_calls, port_calls = [], []
    stub_evaluate(monkeypatch, jax_loop, jax_calls)
    stub_evaluate(monkeypatch, port_loop, port_calls)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", ".cache_name")
    argv = argv + ["--out_dir", tmp_path / "out"]
    assert run_main(monkeypatch, jax_mod.main,
                    argv + ["--out", tmp_path / "jax.json"]) == 0
    assert run_main(monkeypatch, eval_flagship.main,
                    argv + ["--out", tmp_path / "port.json",
                            "--device", "cpu"]) == 0
    (jc,), (pc,) = jax_calls, port_calls
    assert_same_config(jc.pop("config"), pc.pop("config"))
    assert jc == pc
    jax_json = json.loads((tmp_path / "jax.json").read_text())
    port_json = json.loads((tmp_path / "port.json").read_text())
    assert without_wall(port_json) == without_wall(jax_json)
    assert "fid" not in port_json["results"]["underwater"]   # NaN dropped
    assert isinstance(port_json["eval_wall_s"], float)
    assert run_main(monkeypatch, eval_flagship.main, ["--size", "32"]) == 2


def test_sweep_sampler_same_configs_and_json(monkeypatch, tmp_path):
    jax_mod = jax_script("sweep_sampler")
    jax_calls, port_calls = [], []
    stub_evaluate(monkeypatch, jax_loop, jax_calls)
    stub_evaluate(monkeypatch, port_loop, port_calls)
    argv = ["--ckpt", "w.npz", "--points", "ddim:15", "dpm++2m:5",
            "--synthetic_length", "21", "--fid"] + MODEL_ARGV
    assert run_main(monkeypatch, jax_mod.main,
                    argv + ["--out", tmp_path / "jax.json"]) == 0
    assert run_main(monkeypatch, sweep_sampler.main,
                    argv + ["--out", tmp_path / "port.json",
                            "--device", "cpu"]) == 0
    assert len(jax_calls) == len(port_calls) == 2
    assert [(c["config"].sampler, c["config"].ddim_step)
            for c in port_calls] == [("", 15), ("dpm++2m", 5)]
    for jc, pc in zip(jax_calls, port_calls):
        assert_same_config(jc.pop("config"), pc.pop("config"))
        assert jc == pc
    jax_json = json.loads((tmp_path / "jax.json").read_text())
    port_json = json.loads((tmp_path / "port.json").read_text())
    assert without_wall(port_json) == without_wall(jax_json)
    assert [(r["sampler"], r["steps"]) for r in port_json["rows"]] == \
        [("ddim", 15), ("dpm++2m", 5)]


def test_eval_flagship_untrained_runs_on_the_cpu(monkeypatch, tmp_path):
    out = tmp_path / "floor.json"
    argv = ["--untrained", "--device", "cpu", "--batch", "2",
            "--synthetic_length", "14", "--ddim_steps", "3",
            "--out_dir", tmp_path / "eval", "--out", out] + MODEL_ARGV
    assert run_main(monkeypatch, eval_flagship.main, argv) == 0
    summary = json.loads(out.read_text())
    assert summary["sampler"] == "ddim" and summary["steps"] == 3
    for domain in ("underwater", "atmospheric"):
        row = summary["results"][domain]
        assert row["n_images"] == 2
        for k in ("psnr", "ssim", "uiqm", "uciqe"):
            assert math.isfinite(row[k]), (domain, k)


# ---------------------------------------------------------------- export


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    """A JAX DynamicUNet's parameter tree (ch 32, mult (1, 2), 32²; numpy-
    seeded on its template, _torch_parity.random_params) saved as the JAX
    package saves params npz files (fp16)."""
    _, params, _ = tiny_pair(seed=3)
    path = tmp_path_factory.mktemp("npz") / "jax_params.npz"
    save_params_npz(str(path), params)
    return path


def npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_export_npz_reexport_is_byte_equal_to_jax(monkeypatch, tmp_path,
                                                  jax_npz):
    jax_mod = jax_script("export_params")
    for main, name in ((jax_mod.main, "jax"), (export_params.main, "port")):
        assert run_main(monkeypatch, main, ["--ckpt", jax_npz, "--out",
                                            tmp_path / f"{name}.npz"]
                        + MODEL_ARGV) == 0
        # A flat npz holds one subtree: forcing one is refused (exit 2).
        assert run_main(monkeypatch, main, [
            "--ckpt", jax_npz, "--out", tmp_path / "x.npz",
            "--subtree", "ema"] + MODEL_ARGV) == 2
    want, got = npz_arrays(tmp_path / "jax.npz"), npz_arrays(tmp_path /
                                                              "port.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float16, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert json.loads((tmp_path / "port.npz.json").read_text()) == \
        json.loads((tmp_path / "jax.npz.json").read_text())


def port_checkpoint(directory, ema_decay, steps):
    """A port checkpoint (train/checkpoint.py) of _torch_parity's tiny
    U-Net (ch 32, mult (1, 2), 32²) whose raw parameters and EMA differ;
    returns (path, raw, ema)."""
    from hybrid_diffusion_tpu_torch.train.checkpoint import save_checkpoint
    from hybrid_diffusion_tpu_torch.train.train_state import TrainState

    # Unit-gain weights (_torch_parity.random_params): the init's zero
    # biases and 1e-5 tail would hide most of the network from ε.
    _, raw_params, model = tiny_pair(seed=6)
    _, ema_params, _ = tiny_pair(seed=7)
    raw, ema = to_port(raw_params), to_port(ema_params)
    state = TrainState(model, ema_decay=ema_decay)
    state.ema_params = dict(ema)
    state.step = steps
    path = save_checkpoint(str(directory), 1, "Underwater_final", "HICRD",
                           state)
    return path, raw, ema


@pytest.mark.parametrize("decay,steps,subtree,want", [
    (0.5, 10, "auto", "ema_params"),    # 0.5^10 ≈ 1e-3 init mass: mature
    (0.99, 10, "auto", "params"),       # 0.99^10 ≈ 0.90: immature
    (0.99, 10, "ema", "ema_params"),
    (0.5, 10, "raw", "params"),
])
def test_export_checkpoint_takes_the_chosen_subtree(monkeypatch, tmp_path,
                                                    decay, steps, subtree,
                                                    want):
    from hybrid_diffusion_tpu_torch.train.checkpoint import (
        choose_restore_subtree)
    from hybrid_diffusion_tpu_torch.weights import load_npz_state_dict

    path, raw, ema = port_checkpoint(tmp_path / "ck", decay, steps)
    if subtree == "auto":
        assert choose_restore_subtree(path)[0] == want
    out = tmp_path / "w.npz"
    assert run_main(monkeypatch, export_params.main, [
        "--ckpt", path, "--out", out, "--dtype", "float32",
        "--subtree", subtree] + MODEL_ARGV) == 0
    side = json.loads((tmp_path / "w.npz.json").read_text())
    assert side["subtree"] == want and side["step"] == steps
    assert side["ema_decay"] == decay
    assert set(side) == {"subtree", "reason", "step", "ema_decay", "source"}
    exported = load_npz_state_dict(out)
    source = ema if want == "ema_params" else raw
    for n, t in source.items():
        assert torch.equal(exported[n], t), n


@pytest.mark.parametrize("input_seed", [1, 2, 3])
def test_exported_checkpoint_loads_into_the_jax_unet(monkeypatch, tmp_path,
                                                     input_seed):
    path, _, ema = port_checkpoint(tmp_path / "ck", 0.5, 10)
    out = tmp_path / "w.npz"
    assert run_main(monkeypatch, export_params.main, [
        "--ckpt", path, "--out", out, "--dtype", "float32"]
        + MODEL_ARGV) == 0
    model = DynamicUNet(**MODEL)
    model.load_state_dict(ema, strict=True)
    params = load_params_npz(str(out))
    # The file carries the EMA exactly, in the JAX package's layout.
    flat = {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    assert flat.keys() == flat_from_state_dict(ema).keys()
    for k, v in flat_from_state_dict(ema).items():
        assert np.array_equal(flat[k], v), k
    rng = np.random.default_rng(input_seed)
    x6 = rng.uniform(-1, 1, (2, 32, 32, 6)).astype(np.float32)
    t = np.array([2, 17], np.int32)
    want = np.asarray(JaxUNet(**MODEL, dropout=0.0).apply(
        params, jnp.asarray(x6), jnp.asarray(t)))
    with torch.no_grad():
        got = model(torch.from_numpy(x6), torch.from_numpy(t)).numpy()
    assert np.abs(want).max() > 0.1   # the weights reach the output
    assert rel_err(got, want) <= 5e-5


# ---------------------------------------------------------------- rescore


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """tests/test_rescore.py's fixture: GT + uniform ±8 noise written as
    evaluate() writes its results, for both domains' val split (32², 70
    pairs a domain: 10 val images)."""
    from hybrid_diffusion_tpu_torch.data import make_dataset
    from hybrid_diffusion_tpu_torch.data.registry import save_image

    root = tmp_path_factory.mktemp("results")
    for domain in ("underwater", "atmospheric"):
        ds = make_dataset(f"synthetic-{domain}", task="val", image_size=32,
                          synthetic_length=70)
        out = root / f"synthetic-{domain}" / "val"
        out.mkdir(parents=True)
        rng = np.random.RandomState(3)
        for i in range(len(ds)):
            ex = ds[i]
            img = np.clip(ex["gt"].astype(np.int16)
                          + rng.randint(-8, 9, ex["gt"].shape), 0,
                          255).astype(np.uint8)
            save_image(str(out / ex["name"]), img)
    return root


RES_LINE = re.compile(r"split=val n=(\d+) \(rescored, 0-255 UIQM fix\) "
                      r"((?:\w+=-?[\d.]+ ?)+)$")


def test_rescore_matches_jax(monkeypatch, tmp_path, results_dir):
    import shutil

    jax_mod = jax_script("rescore_metrics")
    scored, lines = {}, {}
    for name, main in (("jax", jax_mod.main),
                       ("port", rescore_metrics.main)):
        root = tmp_path / name
        shutil.copytree(results_dir, root)
        assert run_main(monkeypatch, main, [
            "--root", root, "--size", "32", "--synthetic_length", "70",
            "--out", tmp_path / f"{name}.json"]) == 0
        scored[name] = json.loads((tmp_path / f"{name}.json").read_text())
        lines[name] = [(root / f"synthetic-{d}" / "res.txt").read_text()
                       for d in ("underwater", "atmospheric")]
    assert sorted(scored["port"]) == sorted(scored["jax"]) == \
        ["atmospheric", "underwater"]
    for domain, want in scored["jax"].items():
        got = scored["port"][domain]
        assert list(got) == list(want)
        assert got["n_images"] == want["n_images"] == 10
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1.0), (domain, k)
    for got, want in zip(lines["port"], lines["jax"]):
        mg, mw = RES_LINE.match(got.strip()), RES_LINE.match(want.strip())
        assert mg and mw, (got, want)
        assert [kv.split("=")[0] for kv in mg.group(2).split()] == \
            [kv.split("=")[0] for kv in mw.group(2).split()]
        assert mg.group(1) == mw.group(1)


# ---------------------------------------------------------------- preview


@pytest.mark.parametrize("size,max_levels", [(32, 0), (24, 1)])
def test_preview_grid_matches_jax(monkeypatch, tmp_path, results_dir, size,
                                  max_levels):
    import cv2

    jax_mod = jax_script("make_preview_grid")
    grids = {}
    for name, main in (("jax", jax_mod.main),
                       ("port", make_preview_grid.main)):
        out = tmp_path / f"{name}.png"
        assert run_main(monkeypatch, main, [
            "--results", results_dir / "synthetic-underwater" / "val",
            "--dataset", "synthetic-underwater", "--size", size,
            "--synthetic_length", "70", "--rows", "3", "--out", out]) == 0
        grids[name] = cv2.cvtColor(cv2.imread(str(out)), cv2.COLOR_BGR2RGB)
    assert grids["port"].shape == grids["jax"].shape == (3 * size, 3 * size, 3)
    diff = np.abs(grids["port"].astype(int) - grids["jax"].astype(int))
    assert diff.max() <= max_levels

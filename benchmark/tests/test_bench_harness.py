"""The harness finds every piece of a cell by name from files alone, so a
new cell, configuration or metric needs only new files and new entries;
the result line carries the contract's keys; nothing the benchmark runs
loads JAX or the JAX package, and the reference loads nothing of the
program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT


def test_every_cell_is_found_with_its_pieces():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        harness.load_driver(cell.mix["driver"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            harness.reader_path(m["name"])
        assert harness.limits(harness.Run(cell, 0, 1.0, False))


def _copy(tmp_path: Path) -> tuple[Path, Path]:
    """A checkout holding BENCHMARK.json and the benchmark's files."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    return root, root / "benchmark"


def test_new_cell_config_and_metric_need_only_new_files(tmp_path):
    root, bench = _copy(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "cfg-cifar10.json").read_text())
    config["name"] = "cfg-cifar10-w3"
    config["diffusion"]["w"] = 3.0
    (bench / "configs" / "cfg-cifar10-w3.json").write_text(json.dumps(config))
    mix = json.loads((bench / "mixes" / "sample-w1.8.json").read_text())
    mix["per_label"] = 4
    (bench / "mixes" / "sample-half.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_done.py").write_text(
        "def read(run, metric):\n    return run.window.work['model_calls']\n")
    spec["configs"].append({"name": "cfg-cifar10-w3", "source": "x",
                            "file": "benchmark/configs/cfg-cifar10-w3.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new-cell", "config": "cfg-cifar10-w3",
                              "traffic": "sample-half", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "cfg_sample_images_per_s":
            m["workloads"].append("new-cell")
    spec["per_layer"].append({"name": "steps_done.sample", "unit": "1",
                              "better": "higher", "source": "device_trace",
                              "layer": "device",
                              "moves": "cfg_sample_images_per_s",
                              "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell("new-cell", root, bench)
    assert cell.config["diffusion"]["w"] == 3.0
    assert cell.mix["per_label"] == 4
    assert [m["name"] for m in cell.per_layer][-1] == "steps_done.sample"
    read = harness.load_reader("steps_done.sample", bench)
    run = harness.Run(cell, 0, 1.0, True)
    run.window = harness.Window({}, {"model_calls": 7}, 0, 1, 1)
    assert read(run, {}) == 7
    # a stem's reader serves a new suffix too
    assert harness.reader_path("mfu_pct.new", bench).name == "mfu_pct.py"


def test_missing_pieces_are_named():
    with pytest.raises(KeyError, match="no workload"):
        harness.find_cell("no-such-cell")
    with pytest.raises(KeyError, match="no driver"):
        harness.load_driver("no_such_driver")
    with pytest.raises(KeyError, match="no reader"):
        harness.reader_path("no_such_metric.x")


def test_result_line_keys_and_checks_last():
    cell = harness.find_cell("flagship256-enhance-b8")
    run = harness.Run(cell, 0, 1.0, False)
    window = harness.Window({"enhance_images_per_s": 25.0,
                             "enhance_p90_ms": 320.0}, {}, 0, 1, 10)
    checks = [harness.Check("img_mad_levels", 1.0, 4.0)]
    device = {"platform": "gpu", "kind": "k", "count": 1,
              "memory_peak_bytes": 1}
    line = harness.result_line(run, window, checks, device, setup_s=20.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": 20.0, "unit": "s"}
    assert line["checks"] == {"img_mad_levels": {"value": 1.0, "limit": 4.0}}
    run.trace = True
    line = harness.result_line(run, window, [harness.Check("x", 2.0, 1.0)],
                               device, {"mfu_pct.enhance": 9.5}, {"a": []})
    assert line["correct"] is False
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["metrics"]) == {"mfu_pct.enhance"}


def test_percentile_interpolates_between_ranks():
    assert harness.percentile([1, 2, 3, 4, 5], 90) == pytest.approx(4.6)
    assert harness.percentile([3, 1, 2], 50) == 2


def test_no_card_exits_without_a_result(tmp_path):
    """A run on a machine without a card prints no result and fails."""
    code = ("import sys; sys.argv = ['run.py', '--workload', "
            "'flagship256-enhance-b8', '--seed', '1', '--seconds', '1', "
            "'--trace', '0']; import torch; "
            "torch.cuda.is_available = lambda: False; "
            "import runpy; runpy.run_path('benchmark/run.py', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_program_it_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    root, _ = _copy(tmp_path)
    code = ("import sys; sys.argv = ['run.py']; import runpy; "
            "ns = runpy.run_path('benchmark/run.py'); h = ns['harness']; "
            "cell = h.find_cell('flagship256-train-b16'); "
            "ns['run_cell'](h.Run(cell, 1, 1.0, False, device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "No module named 'hybrid_diffusion_tpu_torch'" in proc.stderr
    assert proc.stdout.strip() == ""


IMPORTS = """
import sys, importlib, pathlib
sys.path.insert(0, {root!r})
import benchmark.harness, benchmark.devtrace, benchmark.inputs
import benchmark.trainrun, benchmark.counts.flops, benchmark.counts.attention
import benchmark.reference.unet, benchmark.reference.dino
import benchmark.reference.training, benchmark.reference.sampling
import benchmark.reference.image, benchmark.reference.weights
bench = pathlib.Path({root!r}) / "benchmark"
for p in sorted((bench / "drivers").glob("*.py")):
    importlib.import_module("benchmark.drivers." + p.stem)
for p in sorted((bench / "metrics").glob("*.py")):
    if p.stem != "__init__":
        benchmark.harness.load_reader(p.stem)
{extra}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(extra: str = "") -> set[str]:
    code = IMPORTS.format(root=str(ROOT), extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(out.split())


def test_the_benchmark_loads_no_jax():
    """The harness, every driver, every metric reader and the reference,
    and the program's modules that the drivers call: no module whose whole
    top-level name is forbidden."""
    program = ("import hybrid_diffusion_tpu_torch.serve, "
               "hybrid_diffusion_tpu_torch.cfg.sampler, "
               "hybrid_diffusion_tpu_torch.train.step, "
               "hybrid_diffusion_tpu_torch.losses.perceptual")
    loaded = _top_level_modules(program)
    assert "hybrid_diffusion_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules()
    assert harness.PROGRAM not in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)

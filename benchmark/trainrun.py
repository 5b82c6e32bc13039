"""The training driver's check: the steps that set-up drives and records,
the window of optimizer steps with its first step recorded, and the
comparison of both with the reference's.

Set-up builds one train state (model, AdamW state, step function) from
weights made from the seed, drives it through its first FIRST_STEPS steps
on batches that all differ, through the window's own step call, and hands
that same state to the window. It records each step's loss and which
middle blocks moved, the first step's gradient as the optimizer got it
(clipped and gated: AdamW's first moment after one update is 0.1·g) and
the gated gradients' global norm before the clip, and each leaf's change
over the first steps. Then it keeps a copy of the state the window starts
from (parameters, AdamW's moments and count).

The window's first step is recorded as well: its loss, its gradient norm,
and the parameters and first moments it left (copied once, a few ms of a
window of tens of seconds); its gradient is (m₁ − 0.9·m₀)/0.1.

After the window, with the program's state freed, the reference follows
the first steps from the same weights, batches and draws
(reference/training.py), then the window's first step from the copy of
the program's state at the window's start, with the draws that come next.
The numbers:

  - `loss_rel`: the largest |L − L_ref| / |L_ref| over the first steps,
    and `mse_rel` the same of the loss's MSE term; `loss1_rel`, `mse1_rel`
    the same of the first step alone (before any update, so rounding of
    the forward alone moves them);
  - `norm1_rel`: the first step's gated gradient norm before the clip,
    |‖g‖ − ‖g_ref‖| / ‖g_ref‖;
  - `grad1_rel`: the worst leaf's gap between the norms of the first
    gradients, over the larger of the reference's norm of that leaf and of
    the median leaf; `grad1_mid_rel` and `grad1_attn_rel` the same over
    the middle blocks' leaves and their attention's;
  - `change_rel`: the same for each leaf's change over the first steps,
    over the elements whose reference gradient is not nought to rounding
    (reference/training.py::leaf_gaps says which leaves and elements
    count, by a rule on the reference's first gradient);
  - `grad1_med_rel`, `change_med_rel`: the median leaf's gaps;
  - `gate_errors`: over the first steps and the window's first, the
    middle blocks whose moving disagrees with the reference's gates (a
    closed block's parameters must stay bit for bit, an open one's move);
  - `win_<number>`: the numbers above of the window's first step.

Which of them the cell compares is its limits file's choice.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import harness, inputs
from benchmark.reference import layers, training

FIRST_STEPS = 3
SALT_STEP = 6


def step_generator(run: harness.Run) -> torch.Generator:
    return inputs.generator(run.seed, SALT_STEP, run.device)


def _middle(names) -> dict:
    """{middle block index: [its leaves' names]}."""
    out: dict = {}
    for n in names:
        i = training.middle_block(n)
        if i is not None:
            out.setdefault(i, []).append(n)
    return out


def _moved(before: dict, after: dict, blocks: dict) -> list[bool]:
    """Whether each middle block's parameters changed at all."""
    return [bool(max(float((after[n] - before[n]).detach().abs().max())
                     for n in blocks[i]) > 0) for i in sorted(blocks)]


def _clone(tensors: dict) -> dict:
    return {n: t.detach().clone() for n, t in tensors.items()}


def _exp_avg(ts) -> dict:
    return {n: ts.moments(n)["exp_avg"] for n in ts.params}


def first_steps(run: harness.Run, state: dict) -> None:
    """Drive the program's state through its first steps and record them;
    then copy the state the window starts from."""
    ts, step = state["train_state"], state["step"]
    blocks = _middle(ts.params)
    p0 = _clone(ts.params)
    losses, mse, moved = [], [], []
    for k in range(FIRST_STEPS):
        before = {n: ts.params[n].detach().clone()
                  for b in blocks.values() for n in b}
        ts, metrics = step(ts, state["batches"][k], state["generator"])
        losses.append(metrics["total"])
        mse.append(metrics["mse"])
        moved.append(_moved(before, ts.params, blocks))
        if k == 0:
            norm1 = float(metrics["grad_norm"])
            grad1 = {n: float(m.norm()) / 0.1
                     for n, m in _exp_avg(ts).items()}
    state["program"] = {"losses": [float(x) for x in losses],
                        "mse": [float(x) for x in mse], "norm1": norm1,
                        "grad1": grad1, "moved": moved,
                        "change": {n: p.detach() - p0[n]
                                   for n, p in ts.params.items()}}
    state["start"] = {
        "params": _clone(ts.params), "exp_avg": _clone(_exp_avg(ts)),
        "exp_avg_sq": _clone({n: ts.moments(n)["exp_avg_sq"]
                              for n in ts.params}),
        "count": ts.step}


def window(run: harness.Run, state: dict) -> harness.Window:
    ts, step, gen = state["train_state"], state["step"], state["generator"]
    batches = state["batches"]
    B = run.mix["batch"]
    steps = 0
    start_ns = time.time_ns()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        batch = batches[(FIRST_STEPS + steps) % len(batches)]
        ts, metrics = step(ts, batch, gen)
        if steps == 0:    # the window's first step, for the check
            state["window_step"] = {
                "loss": metrics["total"], "mse": metrics["mse"],
                "norm": metrics["grad_norm"], "params": _clone(ts.params),
                "exp_avg": _clone(_exp_avg(ts))}
        steps += 1
    if run.device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    end_ns = time.time_ns()
    last = float(metrics["total"])
    return harness.Window(
        metrics={"train_images_per_s": B * steps / seconds},
        work={"kind": "train", "model_calls": steps, "batch": B},
        start_ns=start_ns, end_ns=end_ns, attempted=steps,
        failed=0 if math.isfinite(last) else 1)


def window_step(state: dict) -> dict:
    """The window's first step as `first_steps` records a step."""
    start, rec = state["start"], state.pop("window_step")
    blocks = _middle(start["params"])
    return {"losses": [float(rec["loss"])], "mse": [float(rec["mse"])],
            "norm1": float(rec["norm"]),
            "grad1": {n: float((m - 0.9 * start["exp_avg"][n]).norm()) / 0.1
                      for n, m in rec["exp_avg"].items()},
            "moved": [_moved(start["params"], rec["params"], blocks)],
            "change": {n: p - start["params"][n]
                       for n, p in rec["params"].items()}}


def free_program(run: harness.Run, state: dict) -> None:
    for key in ("train_state", "step", "model", "extra"):
        state.pop(key, None)
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def gaps(prog: dict, ref: dict, worst: int = 0) -> dict:
    rel = lambda key: max(abs(a - b) / abs(b)
                          for a, b in zip(prog[key], ref[key]))
    first = lambda key: abs(prog[key][0] - ref[key][0]) / abs(ref[key][0])
    gate_errors = sum(m != g for moved, gates in zip(prog["moved"],
                                                     ref["gates"])
                      for m, g in zip(moved, gates))
    return {"loss_rel": rel("losses"), "mse_rel": rel("mse"),
            "loss1_rel": first("losses"), "mse1_rel": first("mse"),
            "norm1_rel": abs(prog["norm1"] - ref["norm1"]) / ref["norm1"],
            "gate_errors": float(gate_errors),
            **training.leaf_gaps(prog, ref, worst)}


def readings(prog: dict, ref: dict, worst: int = 0) -> dict:
    """Every number of the first steps and, as `win_<number>`, of the
    window's first step; `gate_errors` summed over both."""
    first = gaps(prog["first"], ref["first"], worst)
    win = gaps(prog["window"], ref["window"], worst)
    out = {**first, **{f"win_{k}": v for k, v in win.items()
                       if k != "gate_errors"}}
    out["gate_errors"] = first["gate_errors"] + win["gate_errors"]
    return out


def checks(run: harness.Run, state: dict,
           values: dict) -> list[harness.Check]:
    """The cell's limits' numbers; every reading stays in the state."""
    state["readings"] = values
    limits = harness.limits(run)
    return [harness.Check(k, values[k], limits[k]) for k in limits]


def follow(run: harness.Run, state: dict, build_reference, op) -> dict:
    """The reference's first steps, then the window's first step from the
    program's state at the window's start; its model built by
    build_reference(op) -> (model, vit)."""
    model, vit = build_reference(op)
    gen = step_generator(run)
    batches = state["batches"]
    with layers.fp32_products():
        first = training.follow(run.config, model, vit, batches, gen,
                                FIRST_STEPS)
        start = state["start"]
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start["params"][n])
        window = training.follow(
            run.config, model, vit, [batches[FIRST_STEPS % len(batches)]],
            gen, 1, start)
    return {"first": first, "window": window}

"""The enhancer's training steps, plainly: the diffusion objective, the
domain gates, the clip by global norm and AdamW, in fp32.

Random draws come from the caller's generator in the order the published
step draws them: t ~ U{0..T−1} (B,), ε ~ N(0, 1) of the batch's shape,
then each ResBlock's dropout mask, uniform ≥ p, in the order the blocks
run.

The objective: MSE on ε, plus, on x0 = (x_t − σ_t ε̂)/α_t clipped to
[-1, 1], DINO (dino.py), 1 − MS-SSIM and the angular colour loss on
(x + 1)/2, with the configuration's weights. The gates: the batch is
underwater when its input's mean blue exceeds its mean red; then the even
middle blocks train, else the odd ones; a closed block's gradient is
zeroed before the clip, and after the update its parameters and moments
are put back.

AdamW (Loshchilov & Hutter, arXiv:1711.05101): β 0.9, 0.999, ε 1e-8 added
outside the square root, decay p ← p·(1 − lr·wd) first, bias corrections
by the update count; the rate from a warmup-cosine schedule read at the
count before the update. The clip: g ← g·c/‖g‖ when ‖g‖ ≥ c.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import dino, losses

NUM_MIDDLE_BLOCKS = 4


def tables(beta_1: float, beta_T: float, T: int, device) -> dict:
    """float32 α_t = sqrt(ᾱ_t) and σ_t = sqrt(1 − ᾱ_t) on `device`."""
    ab = np.cumprod(1.0 - np.linspace(beta_1, beta_T, T, dtype=np.float64))
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return {"a": f32(np.sqrt(ab)), "s": f32(np.sqrt(1.0 - ab))}


def to_unit(x_u8: torch.Tensor) -> torch.Tensor:
    return x_u8.float() / 255.0 * 2.0 - 1.0


def _keep(gen: Optional[torch.Generator], p: float, device):
    if gen is None:       # counting on the meta device: every unit kept
        return lambda shape: torch.ones(shape, dtype=torch.bool,
                                        device=device)
    return lambda shape: torch.rand(shape, device=device, generator=gen) >= p


def _draw_t_noise(gen, T: int, shape: tuple, device):
    if gen is None:
        return (torch.zeros(shape[0], dtype=torch.long, device=device),
                torch.zeros(shape, device=device))
    t = torch.randint(0, T, (shape[0],), device=device, generator=gen)
    return t, torch.randn(shape, device=device, generator=gen)


def enhancer_loss(config: dict, model, vit, batch: dict,
                  gen: Optional[torch.Generator], tab: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(total, MSE term)."""
    m, w = config["model"], config["training"]["loss"]
    inp, gt = to_unit(batch["input"]), to_unit(batch["gt"])
    device = gt.device
    t, noise = _draw_t_noise(gen, m["T"], tuple(gt.shape), device)
    a = tab["a"][t].view(-1, 1, 1, 1)
    s = tab["s"][t].view(-1, 1, 1, 1)
    y = a * gt + s * noise
    eps = model(torch.cat([inp, y], -1), t, True,
                _keep(gen, m["dropout"], device))
    x0 = ((y - s * eps) / a).clamp(-1.0, 1.0)
    mse = ((eps - noise) ** 2).mean()
    loss = w["mse"] * mse
    if w.get("dino"):
        loss = loss + w["dino"] * dino.dino_loss(vit, x0, gt)
    if w.get("ms_ssim"):
        loss = loss + w["ms_ssim"] * (1.0 - losses.ms_ssim((x0 + 1) / 2,
                                                            (gt + 1) / 2))
    if w.get("color"):
        loss = loss + w["color"] * losses.color_loss((x0 + 1) / 2,
                                                     (gt + 1) / 2)
    return loss, mse


def domain_gates(batch: dict) -> torch.Tensor:
    """(4,) 0/1: the middle blocks that train on this batch."""
    inp = to_unit(batch["input"])
    uw = (inp[..., 2].mean() > inp[..., 0].mean()).float()
    even = (torch.arange(NUM_MIDDLE_BLOCKS, device=inp.device) % 2 == 0).float()
    return uw * even + (1.0 - uw) * (1.0 - even)


def middle_block(name: str) -> Optional[int]:
    head = name.split(".", 1)[0]
    if head.startswith("middle_") and int(head[7:]) < NUM_MIDDLE_BLOCKS:
        return int(head[7:])
    return None


def warmup_cosine(base: float, epochs: int, steps_per_epoch: int,
                  multiplier: float, count: int) -> float:
    """The rate at update count `count`: linear warmup to base × multiplier
    over the first tenth of the epochs, then cosine decay."""
    warm = max(epochs // 10, 1)
    e = np.float32(count // steps_per_epoch)
    if e <= warm:
        return float(np.float32(base) * (np.float32(multiplier - 1.0) * e
                                         / np.float32(warm) + np.float32(1.0)))
    prog = np.clip((e - warm) / np.float32(epochs), 0.0, 1.0)
    return float(np.float32(base * multiplier * 0.5)
                 * (np.float32(1.0) + np.cos(np.float32(np.pi) * prog)))


class AdamW:
    """With `start` ({"exp_avg", "exp_avg_sq": {leaf: tensor}, "count"}),
    from that state; else from zero moments at count 0. Each step keeps
    the gradient it applied (gated and clipped) in `grads` and the gated
    gradients' global norm before the clip in `norm`."""

    def __init__(self, params: dict, training: dict,
                 start: Optional[dict] = None):
        self.params, self.cfg = params, training
        if start is None:
            self.m = {n: torch.zeros_like(p) for n, p in params.items()}
            self.v = {n: torch.zeros_like(p) for n, p in params.items()}
            self.count = 0
        else:
            self.m = {n: start["exp_avg"][n].clone() for n in params}
            self.v = {n: start["exp_avg_sq"][n].clone() for n in params}
            self.count = start["count"]

    @torch.no_grad()
    def step(self, grads: dict, gates: Optional[torch.Tensor] = None) -> None:
        c = self.cfg
        if gates is not None:
            for n, g in grads.items():
                i = middle_block(n)
                if i is not None:
                    g.mul_(gates[i])
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < c["grad_clip"], 1.0, c["grad_clip"] / norm)
        lr = warmup_cosine(c["lr"], c["epochs"], c["steps_per_epoch"],
                           c["multiplier"], self.count)
        self.count += 1
        k = self.count
        self.norm = float(norm)
        self.grads = {}
        closed = {}
        for n, p in self.params.items():
            i = middle_block(n)
            if gates is not None and i is not None and gates[i] <= 0:
                closed[n] = (p.clone(), self.m[n].clone(), self.v[n].clone())
            g = grads[n] * scale
            self.grads[n] = g
            self.m[n].mul_(0.9).add_(g, alpha=0.1)
            self.v[n].mul_(0.999).add_(g * g, alpha=0.001)
            p.mul_(1.0 - lr * c["weight_decay"])
            denom = (self.v[n] / (1.0 - 0.999 ** k)).sqrt() + 1e-8
            p.sub_(lr * (self.m[n] / (1.0 - 0.9 ** k)) / denom)
        for n, (p, m, v) in closed.items():
            self.params[n].copy_(p)
            self.m[n].copy_(m)
            self.v[n].copy_(v)


def meta_step(config: dict, model, batch: int) -> None:
    """A training step's forward and backward on the meta device, for the
    FLOP count (dropout keeps every unit; the counts do not depend on it)."""
    m = config["model"]
    size = m["img_size"]
    tab = {"a": torch.ones(m["T"], device="meta"),
           "s": torch.ones(m["T"], device="meta")}
    data = {k: torch.zeros(batch, size, size, 3, device="meta")
            for k in ("input", "gt")}
    vit = dino.build(config["training"]["dino"], model.head.op, "meta")
    vit.requires_grad_(False)
    loss, _ = enhancer_loss(config, model, vit, data, None, tab)
    loss.backward()


def follow(config: dict, model, vit, batches: list, gen: torch.Generator,
           steps: int, start: Optional[dict] = None) -> dict:
    """The reference's `steps` steps on `batches` from the model's
    parameters, and from AdamW's state `start` (default: none yet):
    {"losses": [...], "mse": [the MSE term of each], "norm1": the first
    step's gated gradients' global norm before the clip, "grad1": {leaf:
    the first step's gradient as AdamW applied it, gated and clipped},
    "change": {leaf: p_steps − p_0}, "gates": [each step's gates, as
    bools], "moved": [each step's middle blocks: whether any parameter
    changed]}."""
    m = config["model"]
    d = config["diffusion"]
    device = next(model.parameters()).device
    tab = tables(d["beta_1"], d["beta_T"], m["T"], device)
    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    opt = AdamW(params, config["training"], start)
    routed = config["training"]["domain_routing"]
    out = {"losses": [], "mse": [], "gates": [], "moved": []}
    blocks = [[p for n, p in params.items() if middle_block(n) == i]
              for i in range(NUM_MIDDLE_BLOCKS)]
    for k in range(steps):
        before = [[p.detach().clone() for p in b] for b in blocks]
        batch = batches[k]
        loss, mse = enhancer_loss(config, model, vit, batch, gen, tab)
        gates = domain_gates(batch) if routed else \
            torch.ones(NUM_MIDDLE_BLOCKS, device=device)
        grads = dict(zip(params, torch.autograd.grad(loss, list(
            params.values()))))
        out["losses"].append(float(loss.detach()))
        out["mse"].append(float(mse.detach()))
        out["gates"].append([bool(g > 0) for g in gates])
        opt.step(grads, gates if routed else None)
        out["moved"].append([any(bool((p != q).any()) for p, q in zip(b, c))
                             for b, c in zip(blocks, before)])
        if k == 0:
            out["grad1"], out["norm1"] = opt.grads, opt.norm
    out["change"] = {n: p.detach() - p0[n] for n, p in params.items()}
    return out


def _norm(x) -> float:
    return x if isinstance(x, float) else float(x.float().norm())


def leaf_gaps(prog: dict, ref: dict, worst: int = 0) -> dict:
    """The worst leaf's gap between the program's and the reference's
    first gradients and changes, each |‖a‖ − ‖b‖| over the larger of the
    reference's norm of that leaf and of the median leaf; the median
    leaf's gap of each; and the worst gradient gap over the middle blocks'
    leaves (`grad1_mid_rel`) and over their attention's (`grad1_attn_rel`).

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of all of them (a closed block's, and a leaf that
    rounding alone moves). Inside a leaf, the change counts only the
    elements whose reference gradient is at least a thousandth of the
    median leaf's RMS gradient: an element whose gradient is nought to
    rounding (the key part of a packed q|k|v bias, under softmax) moves
    under Adam by round-off alone. `prog`'s first gradients may be norms.
    With `worst`, the `worst` largest gaps of each, by leaf, as well."""
    g = ref["grad1"]
    g_norm = {n: _norm(t) for n, t in g.items()}
    med_g = float(np.median(list(g_norm.values())))
    keep = [n for n in g if g_norm[n] >= 1e-3 * med_g]
    med = float(np.median([g_norm[n] for n in keep]))
    grad_by = {n: abs(_norm(prog["grad1"][n]) - g_norm[n]) / max(g_norm[n], med)
               for n in keep}
    rms = float(np.median([g_norm[n] / g[n].numel() ** 0.5 for n in keep]))
    a, b = {}, {}
    for n in keep:
        mask = g[n].abs() >= 1e-3 * rms
        if bool(mask.any()):
            a[n] = float(prog["change"][n][mask].norm())
            b[n] = float(ref["change"][n][mask].norm())
    med_c = float(np.median(list(b.values())))
    change_by = {n: abs(a[n] - b[n]) / max(b[n], med_c) for n in b}
    mid = [n for n in keep if middle_block(n) is not None]
    attn = [n for n in mid if ".attn." in n]
    out = {"grad1_rel": max(grad_by.values()),
           "change_rel": max(change_by.values()),
           "grad1_med_rel": float(np.median(list(grad_by.values()))),
           "change_med_rel": float(np.median(list(change_by.values()))),
           "grad1_mid_rel": max(grad_by[n] for n in mid),
           "grad1_attn_rel": max(grad_by[n] for n in attn)}
    if worst:   # the worst leaves, for a look at what drives each number
        for key, by in (("grad1_worst", grad_by), ("change_worst", change_by)):
            out[key] = [[n, by[n], g_norm[n]] for n in
                        sorted(by, key=by.get, reverse=True)[:worst]]
    return out

"""The training cells' comparison: three held steps against the plain
reference.

Set-up drives the program's engine, the object the window then trains,
through its first steps with the window's own step call and feed, on
batches of rows that all differ. Before each step it copies the engine's
whole state to the host (weights, norm buffers, the optimizer's moments
and counts) with the step's rows and generator state; after the last it
copies the state once more. Once the window has closed, the reference
takes each step from the program's state before it (a held step: a run
left free drifts apart by chance, since Adam turns a rounding-level flip
of a near-zero gradient's sign into a change of 2 lr) and the numbers
below hold the program's step against it:

- ``loss_gap``: each step's loss, |program - reference| / |reference|,
  the worst of the steps;
- ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment after one step over 1 - b1), by the worst leaf: the gap
  between the program's norm and the reference's, against the larger of
  the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over the steps (the program's
  last state less its first, against the sum of the reference's held
  changes), by the worst leaf as above; leaves whose reference gradient
  is under a thousandth of the median leaf's are left out (a bias before
  a BatchNorm has a gradient of rounding alone, which Adam blows up to
  lr);
- ``stats_gap`` (models with running statistics): each step's change of
  every float buffer, |program - reference| / |reference| as norms of the
  change vectors, the worst buffer and step;
- ``start_gap``: the program's first state against the weights the
  benchmark made, exactly (0), with an empty optimizer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from .reference import adamw as ref_opt

Tensors = Dict[str, torch.Tensor]
SMALL_GRAD = 1e-3


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def snapshot(engine) -> Dict:
    """The engine's state on the host: params, float buffers, the
    optimizer's per-leaf moments and update counts, its schedule count."""
    model = engine.model
    names = [n for n, _ in model.named_parameters()]
    sd = engine.opt.state_dict()
    opt = sd["opt"]
    order = opt["param_groups"][0]["params"]
    m, v, steps = {}, {}, {}
    for idx, name in zip(order, names):
        st = opt["state"].get(idx)
        if st:
            m[name] = _host(st["exp_avg"])
            v[name] = _host(st["exp_avg_sq"])
            steps[name] = int(st["step"])
    return {"params": {n: _host(p) for n, p in model.named_parameters()},
            "buffers": {n: _host(b) for n, b in model.named_buffers()
                        if b.is_floating_point()},
            "m": m, "v": v, "steps": steps, "count": int(sd["count"])}


@dataclass
class HeldRecord:
    """What set-up copied: states[t] before step t (and after the last),
    each step's feed and the program's loss."""

    initial: Tensors
    states: List[Dict] = field(default_factory=list)
    feeds: List[Dict] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _worst_leaf(prog: Tensors, ref: Tensors, keep) -> float:
    norms = {k: _norm(ref[k]) for k in ref}
    median = float(torch.tensor(sorted(norms.values())).median())
    worst = 0.0
    for k in ref:
        if not keep(k):
            continue
        gap = abs(_norm(prog[k]) - norms[k]) / max(norms[k], median, 1e-30)
        worst = max(worst, gap)
    return worst


def held_steps(rec: HeldRecord, step_fn: Callable, hyper: Dict,
               device) -> List[Dict]:
    """The reference's step from each recorded state. ``step_fn(state,
    feed)`` (tensors on ``device``) returns (loss, grads, new buffers);
    ``hyper``: lr, weight_decay, clip, t_max, steps_per_epoch."""
    out = []
    for t, feed in enumerate(rec.feeds):
        st = rec.states[t]
        on = {k: x.to(device) for k, x in st["params"].items()}
        bufs = {k: x.to(device) for k, x in st["buffers"].items()}
        loss, grads, new_bufs = step_fn({**on, **bufs}, feed)
        grads = ref_opt.clip_global(grads, hyper["clip"])
        lr = ref_opt.cosine_lr(hyper["lr"], hyper["t_max"],
                               hyper["steps_per_epoch"], st["count"])
        p, _, _ = ref_opt.adamw(
            on, grads, {k: x.to(device) for k, x in st["m"].items()},
            {k: x.to(device) for k, x in st["v"].items()}, st["steps"], lr,
            hyper["weight_decay"])
        out.append({"loss": float(loss),
                    "grads": {k: _host(g) for k, g in grads.items()},
                    "params": {k: _host(x) for k, x in p.items()},
                    "buffers": {k: _host(x) for k, x in new_bufs.items()}})
    return out


def program_side(rec: HeldRecord) -> Dict:
    """The program's readings from its record: each step's loss, the first
    gradient (its first moment after one step over 1 - b1), its change
    over the steps and each step's buffer changes."""
    s0, s1, last = rec.states[0], rec.states[1], rec.states[-1]
    return {
        "losses": list(rec.losses),
        "grad1": {k: m / (1 - ref_opt.B1) for k, m in s1["m"].items()},
        "change": {k: last["params"][k] - s0["params"][k]
                   for k in s0["params"]},
        "buffers": [{k: a["buffers"][k] - b["buffers"][k]
                     for k in b["buffers"]}
                    for b, a in zip(rec.states, rec.states[1:])]}


def reference_side(rec: HeldRecord, ref: List[Dict]) -> Dict:
    """The same readings from held reference steps (``held_steps``)."""
    return {
        "losses": [r["loss"] for r in ref],
        "grad1": ref[0]["grads"],
        "change": {k: sum(r["params"][k] - st["params"][k]
                          for r, st in zip(ref, rec.states))
                   for k in ref[0]["params"]},
        "buffers": [{k: b - st["buffers"][k] for k, b in r["buffers"].items()}
                    for r, st in zip(ref, rec.states)]}


def start_gap(rec: HeldRecord) -> float:
    """Largest difference of the program's first state from the weights
    the benchmark made; infinite when the optimizer was not fresh."""
    s0 = rec.states[0]
    if s0["m"] or s0["count"]:
        return float("inf")
    return max(float((x - rec.initial[k]).abs().max())
               for part in ("params", "buffers") for k, x in s0[part].items())


def compare(cand: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of the module's notes: ``cand`` (``program_side``, or a
    control's ``reference_side``) against the reference's readings."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(cand["losses"], ref["losses"]))
    g_ref = ref["grad1"]
    g_cand = {k: cand["grad1"].get(k, torch.zeros_like(g))
              for k, g in g_ref.items()}
    gnorm = {k: _norm(g) for k, g in g_ref.items()}
    gmed = float(torch.tensor(sorted(gnorm.values())).median())
    out = {"loss_gap": loss_gap,
           "grad_gap": _worst_leaf(g_cand, g_ref, lambda k: True),
           "change_gap": _worst_leaf(
               cand["change"], ref["change"],
               lambda k: gnorm[k] >= SMALL_GRAD * gmed)}
    if ref["buffers"] and ref["buffers"][0]:
        out["stats_gap"] = max(
            _norm(c[k] - r[k]) / max(_norm(r[k]), 1e-30)
            for c, r in zip(cand["buffers"], ref["buffers"]) for k in r)
    return out


def left_out(ref: List[Dict]) -> List[str]:
    """Leaves the change leaves out (for the record)."""
    gnorm = {k: _norm(g) for k, g in ref[0]["grads"].items()}
    gmed = float(torch.tensor(sorted(gnorm.values())).median())
    return sorted(k for k, n in gnorm.items() if n < SMALL_GRAD * gmed)


def readings(rec: HeldRecord, run_steps: Callable, control: bool = False,
             notes: Optional[Dict] = None) -> Dict[str, float]:
    """The compared numbers. ``run_steps(tf32)`` gives the reference's
    held steps; the control puts the reference in TF32 in the program's
    place. ``notes`` gets the leaves the change leaves out."""
    steps = run_steps(False)
    if notes is not None:
        notes["left_out"] = left_out(steps)
    ref = reference_side(rec, steps)
    if control:
        return compare(reference_side(rec, run_steps(True)), ref)
    out = compare(program_side(rec), ref)
    out["start_gap"] = start_gap(rec)
    return out

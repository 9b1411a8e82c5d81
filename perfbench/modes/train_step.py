"""Training steps back to back: item i is the program's
`train.train_step` at key `seed` (the step adds its own count), ending in
a synchronize.

Set-up builds the program's scene from the configuration's file, applies
the traffic's `start` to its leaves (`set`: every value to one number;
`scale`: times one number), and hands the program a target frame the
plain reference rendered from the unchanged scene at `target_seed`. It
builds one `TrainState` (the leaves in `trainable` train, Adam at `lr`)
and drives it through the window's own call for its first `follow`
steps, which warm every kernel; the window goes on from there with the
same state.

The check follows those steps with the plain reference from the same
start and target (perfbench/reference/train.py) and compares:
`loss_gap`, each followed step's loss, relative; `grad_gap`, the norm of
the first gradient as the optimizer got it (its first moment after one
step over 1 - beta1), by the worst leaf; `change_gap`, the norm of each
leaf's change over the followed steps, by the worst leaf. A leaf's gap is
measured against the larger of the reference's norm of that leaf and the
median leaf's. Leaves whose reference gradient is under a thousandth of
the median leaf's (nought to rounding: their moves would be Adam's
round-off) are left out of both.
"""

from __future__ import annotations

import statistics

import torch

from perfbench.modes import frame

MASK32 = 0xFFFFFFFF
B1 = 0.9
QUIET = 1e-3  # a leaf's gradient under this share of the median's is nought


def start_values(values: dict, start: dict) -> dict:
    """{name: tensor} with the traffic's start applied."""
    out = dict(values)
    for name, op in start.items():
        v = values[name]
        out[name] = (torch.full_like(v, op["set"]) if "set" in op
                     else v * op["scale"])
    return out


def setup(run):
    from perfbench.reference import train as ref_train
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.scene.types import (
        leaf_items,
        replace_leaves,
    )

    tr = run.traffic
    cfg = frame.render_config(run)
    scene = frame.build_scene(run, cfg)
    rscene, rcfg = run.reference()
    target = ref_train.target_frame(rscene, rcfg, tr["target_seed"],
                                    device=run.device)
    names = [n for n, _ in leaf_items(scene)]
    vals = start_values(dict(leaf_items(scene)), tr["start"])
    scene = replace_leaves(scene, [vals[n] for n in names])
    mask = train.make_trainable_mask(scene, tuple(tr["trainable"]))
    st = {"cfg": cfg, "target": target, "mask": mask, "train": train,
          "key": run.seed & MASK32,
          "state": train.init_state(scene, tr["lr"], mask)}
    trained = [n for n in names if bool(mask[n].any())]
    leaves = dict(leaf_items(st["state"].scene))
    p0 = {n: leaves[n].detach().clone() for n in trained}
    losses, first = [], None
    for i in range(tr["follow"]):
        losses.append(float(step(run, st, i)))
        if first is None:
            opt = st["state"].optimizer
            first = {n: (opt.state[leaves[n]]["exp_avg"] / (1 - B1)).clone()
                     if leaves[n] in opt.state else torch.zeros_like(p0[n])
                     for n in trained}
    st["followed"] = {"losses": losses, "first": first,
                      "change": {n: leaves[n].detach() - p0[n]
                                 for n in trained},
                      "target": target}
    return st


def step(run, state, i):
    state["state"], loss = state["train"].train_step(
        state["state"], state["cfg"], state["key"], state["target"],
        trainable=state["mask"])
    run.sync()
    return loss


def keep_count(run) -> int:
    return 0


def keepsake(run, state, loss):
    return None


def release(run, state, keep):
    kept = state["followed"]
    state.clear()
    return kept


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict, counted) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of the
    reference's norm of that leaf and of the median counted leaf."""
    p, r = _norms(prog), _norms(ref)
    med = statistics.median(r[k] for k in counted)
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in counted)


def readings(run, kept, stand_in=None):
    """{number: reading} of the program's followed steps (or of
    `stand_in`, a dict like `kept` from another computation, such as the
    control) against the plain reference's."""
    from perfbench.reference import train as ref_train

    tr = run.traffic
    scene, cfg = run.reference()
    names = [n for n, _ in scene.leaves()
             if any(n.startswith(p) for p in tr["trainable"])]
    scene = scene.with_leaves(start_values(dict(scene.leaves()), tr["start"]))
    p0 = {n: v.detach().clone() for n, v in scene.leaves() if n in names}
    losses, first, after = ref_train.follow(
        scene, cfg, run.seed & MASK32, kept["target"], names, tr["lr"],
        tr["follow"], torch.float32)
    got = kept if stand_in is None else stand_in
    gn = _norms(first)
    med = statistics.median(gn.values())
    counted = [n for n in names if gn[n] >= QUIET * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], losses)),
        "grad_gap": leaf_gaps({n: got["first"][n] for n in counted},
                              {n: first[n] for n in counted}, counted),
        "change_gap": leaf_gaps({n: got["change"][n] for n in counted},
                                {n: after[n] - p0[n] for n in counted},
                                counted),
    }


def check(run, kept):
    nums = readings(run, kept)
    lim = run.traffic["compare"]["limits"]
    out = {k: (v if v == v else float("inf"), lim[k]) for k, v in nums.items()}
    return out, int(any(v > lim for v, lim in out.values()))

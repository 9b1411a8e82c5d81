"""The comparison's control: the plain reference computed in bfloat16, the
precision below the float32 that every configuration states, put in the
program's place and held to the same numbers and limits. It has to come
out not correct; its readings bound each limit from above.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3

prints, per seed, one JSON line of the numbers the cell's check compares
(frames: the frames and pixels a run would draw for its first items;
training: the followed steps) and whether they pass the limits. Runs on
the card when one is visible, else on the CPU. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import run as harness

CONTROL_DTYPE = torch.bfloat16


def frame_control(run, frames: int):
    from perfbench.modes import frame
    from perfbench.reference.render import render_pixels

    low, cfg = run.reference(CONTROL_DTYPE)
    px = frame.pixels(run)
    kept = [(i, px, None) for i in range(frames)]
    return frame.readings(
        run, kept, program=lambda seed, px: render_pixels(
            low, cfg, seed, px, CONTROL_DTYPE))


def train_control(run):
    from perfbench.modes import train_step
    from perfbench.reference import train as ref_train

    tr = run.traffic
    scene, cfg = run.reference()
    target = ref_train.target_frame(scene, cfg, tr["target_seed"],
                                    device=run.device)
    low, _ = run.reference(CONTROL_DTYPE)
    names = [n for n, _ in low.leaves()
             if any(n.startswith(p) for p in tr["trainable"])]
    low = low.with_leaves(train_step.start_values(dict(low.leaves()),
                                                  tr["start"]))
    p0 = {n: v.detach().clone() for n, v in low.leaves() if n in names}
    losses, first, after = ref_train.follow(
        low, cfg, run.seed & harness.MASK32, target, names, tr["lr"],
        tr["follow"], CONTROL_DTYPE)
    stand_in = {"losses": losses,
                "first": {n: v.float() for n, v in first.items()},
                "change": {n: (after[n] - p0[n]).float() for n in names}}
    nums = train_step.readings(run, {"target": target}, stand_in)
    lim = tr["compare"]["limits"]
    return nums, int(any(nums[k] > lim[k] for k in nums))


def control(root, cell: str, seed: int, backend: str, frames: int = 4):
    """(numbers, items over a limit) of the control for one seed."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    run = harness.Run(root, bench, cell, seed, 0.0, False, backend)
    if run.traffic["mode"] == "train_step":
        return train_control(run)
    return frame_control(run, min(frames, run.traffic["compare"]["frames"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    backend = "cuda" if torch.cuda.is_available() else "torch"
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in a.seeds.split(",")):
        nums, failed = control(harness.ROOT, a.workload, seed, backend)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "dtype": str(CONTROL_DTYPE), "numbers": nums,
                          "over_limit": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

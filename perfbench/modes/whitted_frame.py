"""Whitted frames back to back (a closed loop): the loop, items, set-up
and keepsakes of perfbench/modes/frame.py, checked against the plain
Whitted reference (perfbench/reference/whitted.py) in place of the
linear one. A cell's configuration is clean without Monte-Carlo paths,
so `render` takes the program's Whitted frontier.

The check, as frame.py's: `compare.frames` frames of the window and in
them `compare.pixels` pixels, drawn from the seed, against the
reference's radiance of the same pixels at the same frame seed; per
frame `share_off` (the share of values off by more than
`compare.value_tol`) and `mean_gap` (the mean absolute difference), each
reported as the largest over the frames and held to its limit.

    python3 -m perfbench.modes.whitted_frame --control --workload <cell> \
        --seeds 1,2,3
    python3 -m perfbench.modes.whitted_frame --fault answer_altered \
        --workload <cell> --seeds 1,2,3 [--seconds 2]

print per seed one JSON line of the compared numbers: of the reference
computed in bfloat16 in the program's place (the control, on the frames
and pixels a run draws for its first items; on the card when one is
visible, else on the CPU), or of a run with a fault of
perfbench/faults.py planted under the timed path. The benchmark's own
runs do neither.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench.modes.frame import (  # noqa: F401  (the mode's interface)
    frame_seed,
    keep_count,
    keepsake,
    pixels,
    release,
    setup,
    step,
)

CONTROL_DTYPE = torch.bfloat16


def readings(run, kept, program=None):
    """{number: largest over the kept frames} of the program's values (or
    of `program(seed, pixels)`'s, a stand-in such as the control) against
    the reference, and the number of frames over a limit."""
    from perfbench.reference.whitted import render_pixels

    cmp = run.traffic["compare"]
    scene, cfg = run.reference()
    worst = {"share_off": 0.0, "mean_gap": 0.0}
    failed = 0
    for i, px, vals in kept:
        seed = frame_seed(run, i)
        pxd = px.to(run.device)
        with torch.no_grad():
            ref = render_pixels(scene, cfg, seed, pxd)
            if program is not None:
                vals = program(seed, pxd).float()
        # a value that is not finite is off by any measure
        gap = torch.nan_to_num((vals.to(ref.device) - ref).abs(),
                               nan=float("inf"))
        nums = {"share_off": float((gap > cmp["value_tol"]).float().mean()),
                "mean_gap": float(gap.mean())}
        failed += any(nums[k] > cmp["limits"][k] for k in nums)
        worst = {k: max(worst[k], nums[k]) for k in worst}
    return worst, failed


def check(run, kept):
    worst, failed = readings(run, kept)
    lim = run.traffic["compare"]["limits"]
    return {k: (v, lim[k]) for k, v in worst.items()}, failed


def control(run, frames: int = 4):
    """(numbers, frames over a limit) of the reference in CONTROL_DTYPE in
    the program's place, on the frames and pixels a run draws first."""
    from perfbench.reference.whitted import render_pixels

    low, cfg = run.reference(CONTROL_DTYPE)
    px = pixels(run)
    kept = [(i, px, None) for i in range(min(frames, keep_count(run)))]
    return readings(run, kept, program=lambda seed, p: render_pixels(
        low, cfg, seed, p, CONTROL_DTYPE))


def main(argv=None) -> int:
    from perfbench import faults
    from perfbench import run as harness

    p = argparse.ArgumentParser(prog="python3 -m perfbench.modes."
                                     "whitted_frame")
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--control", action="store_true")
    what.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="2")
    a = p.parse_args(argv)
    if a.fault:
        return faults.main(["--workload", a.workload, "--fault", a.fault,
                            "--seeds", a.seeds, "--seconds", a.seconds])
    backend = "cuda" if torch.cuda.is_available() else "torch"
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for seed in (int(s) for s in a.seeds.split(",")):
        run = harness.Run(harness.ROOT, bench, a.workload, seed, 0.0, False,
                          backend)
        nums, failed = control(run)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "dtype": str(CONTROL_DTYPE), "numbers": nums,
                          "over_limit": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

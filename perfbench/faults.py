"""Faults planted under the timed path, to show that the comparison
catches them: each is Python that replaces one function of the program
before a run. The CPU tests plant each in a tiny run and see `correct`
come out false; on the card,

    python3 -m perfbench.faults --workload <cell> --fault <name> \
        --seeds 1,2,3 --seconds 2

prints each seed's compared numbers with the fault in place, the
readings that bound a training cell's limits from above. The
benchmark's own runs never plant one.
"""

from __future__ import annotations

import argparse
import json
import sys

_RENDERER = "import skele_raytracer_tpu_torch.models.renderer as R\n"
_TRAIN = "import skele_raytracer_tpu_torch.models.train as T\n"

# name -> (the mode it breaks, the code that plants it)
FAULTS = {
    # an answer altered where it is produced
    "answer_altered": ("frame", _RENDERER + """
_orig = R.render_ids_chunked
def _bad(scene, cfg, seed, ids):
    out = _orig(scene, cfg, seed, ids).clone()
    out[:, 0] += 1e-3
    return out
R.render_ids_chunked = _bad
"""),
    # half of the batch left out: the second half of the ids never renders
    "half_frame": ("frame", _RENDERER + """
import torch
_orig = R.render_ids_chunked
def _bad(scene, cfg, seed, ids):
    h = ids.shape[0] // 2
    out = _orig(scene, cfg, seed, ids[:h])
    return torch.cat([out, torch.zeros_like(out[:ids.shape[0] - h])])
R.render_ids_chunked = _bad
"""),
    # a step that returns its state unchanged
    "state_unchanged": ("train_step", _TRAIN + """
def _bad(state, cfg, key, target, mesh=None, trainable=None):
    loss = T.full_loss(state.scene, cfg,
                       (int(key) + state.step) & 0xFFFFFFFF, target)
    return state._replace(step=state.step + 1), loss.detach()
T.train_step = _bad
"""),
    # half of the batch left out, the mean taken over the rest
    "half_batch_loss": ("train_step", _TRAIN + """
import torch
def _bad(scene, cfg, key, target):
    n = cfg.height * cfg.width // 2
    cfg = cfg.resolved()
    ids = torch.arange(n, device=cfg.device)
    rad = T.render_ids_chunked(scene, cfg, key, ids)
    t = T._as_image(target, rad.device).reshape(-1, 3)[:n]
    return torch.mean((rad - t) ** 2)
T.full_loss = _bad
"""),
}


def plant(name: str) -> None:
    exec(FAULTS[name][1], {})


def main(argv=None) -> int:
    from perfbench import run

    p = argparse.ArgumentParser(prog="python3 -m perfbench.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="2")
    a = p.parse_args(argv)
    plant(a.fault)
    for seed in a.seeds.split(","):
        rc, res = run.execute(["--workload", a.workload, "--seed", seed,
                               "--seconds", a.seconds, "--trace", "0"])
        print(json.dumps({"workload": a.workload, "fault": a.fault,
                          "seed": int(seed), "rc": rc,
                          "correct": res and res["correct"],
                          "checks": res and res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

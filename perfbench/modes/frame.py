"""Frames back to back (a closed loop): item i is
`render(scene, cfg, seed * 10**6 + i)` (mod 2**32) followed by a
synchronize, so a frame ends when its radiance is ready on the device.

Set-up parses the configuration's scene file with the program's parser,
builds its scene on the device (`scene_build_s`) and renders one warm
frame at a seed no window reaches. The traffic's `render` fields are
passed to `RenderConfig` as they are (`fused_megakernel` picks the fused
route).

The check: `compare.frames` frames of the window, drawn from the seed,
and in them `compare.pixels` pixels drawn from the seed, against the plain
reference's radiance of the same pixels at the same frame seed. Per
frame, `share_off` is the share of compared values off by more than
`compare.value_tol`, and `mean_gap` the mean absolute difference; each
number reported is the largest over the frames, held to its limit in
`compare.limits`.
"""

from __future__ import annotations

import time

import torch

MASK32 = 0xFFFFFFFF
WARM_ITEM = 999_999


def frame_seed(run, i: int) -> int:
    return (run.seed * 10 ** 6 + i) & MASK32


def render_config(run):
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig

    c = run.config
    return RenderConfig(
        width=c["width"], height=c["height"], monte_carlo=c["gillum"] > 0,
        num_paths=max(c["gillum"], 1), max_depth=c["depth"],
        use_shadows=c["shadows"], grid_size=c["jsample"],
        quirks=PARITY if c["semantics"] == "parity" else CLEAN,
        backend=run.backend, **run.traffic.get("render", {}))


def build_scene(run, cfg):
    """The program's scene from the configuration's file, timed."""
    import os

    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    t0 = time.perf_counter()
    scene = parse_scene(os.fspath(run.root / run.config["scene"])).to_scene(
        cfg.quirks, device=run.device)
    run.sync()
    run.spans["scene_build_s"] = time.perf_counter() - t0
    return scene


def setup(run):
    from skele_raytracer_tpu_torch.models.renderer import render

    cfg = render_config(run)
    scene = build_scene(run, cfg)
    render(scene, cfg, frame_seed(run, WARM_ITEM))
    px = pixels(run)
    return {"scene": scene, "cfg": cfg, "render": render, "pixels": px,
            "pixels_dev": px.to(run.device)}


def step(run, state, i):
    img = state["render"](state["scene"], state["cfg"], frame_seed(run, i))
    run.sync()
    return img


def keep_count(run) -> int:
    return run.traffic["compare"]["frames"]


def pixels(run):
    """The run's compared pixels, drawn from the seed."""
    c, n = run.config, run.traffic["compare"]["pixels"]
    g = torch.Generator().manual_seed(run.seed & MASK32)
    return torch.randperm(c["width"] * c["height"], generator=g)[:n]


def keepsake(run, state, img):
    """What the check needs of a kept frame: the values of the compared
    pixels (a gather on the device, so no whole frame is held)."""
    return state["pixels"], img.reshape(-1, 3)[state["pixels_dev"]]


def release(run, state, keep):
    """[(item, pixel ids, values [n, 3])] of the kept frames; the
    program's state is dropped."""
    state.clear()
    return [(i, px, vals.float()) for i, (px, vals) in keep]


def readings(run, kept, program=None):
    """{number: largest over the kept frames} of the program's values
    (or of `program(seed, pixels)`'s, a stand-in such as the control)
    against the reference, and the number of frames over a limit."""
    from perfbench.reference.render import render_pixels

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

"""spheres2 in clean semantics on the card, at the benchmark's 1920x1080:
K1 (point lights with the fog's terms, directional lights, shadow scans)
against the plain reference on sampled pixels, one `train_step` (K1 with
records, K2) against the reference's first gradient, and the
`k1.records` counter's cost in a traced step. Beside
test_perfbench_reference.py's card test, which covers parity."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench.modes.train_step import B1, QUIET, leaf_gaps, start_values
from perfbench.reference import render as rr
from perfbench.reference import scene as rs
from perfbench.reference import train as rt
from perfbench.tests.test_perfbench_reference import (
    SPHERES2,
    port_cfg,
    port_radiance,
    port_scene,
)
from perfbench.tests.tiny import REPO

CLEAN = rr.Config(1920, 1080, False, 16, 2, True)
TRAFFIC = json.loads((REPO / "perfbench" / "traffic" / "train-fog.json")
                     .read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
def test_clean_k1_matches_the_reference_on_the_card(card):
    g = torch.Generator().manual_seed(13)
    px = torch.randperm(CLEAN.width * CLEAN.height, generator=g)[:8192]
    ref = rr.render_ids(rs.build(rs.parse(SPHERES2), False, device=card),
                        CLEAN, 7, px.cuda()).cpu()
    prog = port_radiance(SPHERES2, CLEAN, 7, px, card, card)
    gap = (ref - prog).abs()
    assert (gap > 1e-4).float().mean() <= 0.02
    assert gap.mean() <= 1e-3


def _fog_state(target):
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.scene.types import (
        leaf_items,
        replace_leaves,
    )

    ps = port_scene(SPHERES2, False, "cuda")
    vals = start_values(dict(leaf_items(ps)), TRAFFIC["start"])
    ps = replace_leaves(ps, [vals[n] for n, _ in leaf_items(ps)])
    mask = train.make_trainable_mask(ps, tuple(TRAFFIC["trainable"]))
    return train.init_state(ps, TRAFFIC["lr"], mask), mask


@pytest.mark.cuda
def test_clean_train_step_matches_the_reference_on_the_card(card):
    """One step of the fog traffic: the loss and the first gradient as
    Adam got it against the reference's, by the cell's measures; one K1
    with records and one K2."""
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace
    from skele_raytracer_tpu_torch.scene.types import leaf_items

    names = TRAFFIC["trainable"]
    sc = rs.build(rs.parse(SPHERES2), False, device=card)
    target = rt.target_frame(sc, CLEAN, TRAFFIC["target_seed"], device=card)
    sc = sc.with_leaves(start_values(dict(sc.leaves()), TRAFFIC["start"]))
    loss_ref, first = rt.loss_and_grads(sc, CLEAN, 41, target, names,
                                        torch.float32)

    state, mask = _fog_state(target)
    leaves = dict(leaf_items(state.scene))
    before = dict(pathtrace.LAUNCHES)
    state, loss = train.train_step(state, port_cfg(CLEAN, "cuda"), 41,
                                   target, trainable=mask)
    assert pathtrace.LAUNCHES["pathtrace_records"] == (
        before["pathtrace_records"] + 1)
    assert pathtrace.LAUNCHES["pathtrace_bwd"] == before["pathtrace_bwd"] + 1
    opt = state.optimizer
    got = {n: (opt.state[leaves[n]]["exp_avg"] / (1 - B1))[
        :first[n].shape[0]] for n in names}
    norms = {n: float(first[n].norm()) for n in names}
    med = sorted(norms.values())[len(norms) // 2]
    counted = [n for n in names if norms[n] >= QUIET * med]
    assert {"fog.albedo", "fog.scattering", "spheres.diffuse"} <= set(counted)
    assert abs(float(loss) - loss_ref) <= 1e-3 * loss_ref
    assert leaf_gaps({n: got[n] for n in counted},
                     {n: first[n] for n in counted}, counted) <= 1e-3


@pytest.mark.cuda
def test_the_counter_adds_no_launch_to_a_traced_step(card, monkeypatch):
    """The kernels a profiler records in a traced clean step are the same
    with the counter keeping K1's records and without; its reductions run
    at the first read, after the take."""
    from torch.profiler import ProfilerActivity, profile

    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.utils import profiling

    cfg = port_cfg(rr.Config(480, 270, False, 16, 2, True), "cuda")
    target = torch.zeros(270, 480, 3, device=card)

    def kernels():
        state, mask = _fog_state(target)
        train.train_step(state, cfg, 3, target, trainable=mask)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train.train_step(state, cfg, 3, target, trainable=mask)
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset")))

    counter = profiling.RecordCounts()
    monkeypatch.setitem(profiling.COUNTERS, "k1.records", counter)
    counted = kernels()
    assert counter._held
    slots = counter["slots"]
    assert len(slots) == 17 and slots[0]["records"] == 480 * 270
    monkeypatch.setattr(profiling.RecordCounts, "hold",
                        lambda self, reduce: None)
    assert kernels() == counted

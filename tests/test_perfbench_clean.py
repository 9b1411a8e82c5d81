"""spheres2 in clean semantics (the benchmark's `spheres2-1080p-clean`
configuration) on the CPU: the plain reference against the program's
plain path for a fog-training step, the `k1.records` counter against a
count taken by hand from the records, the counter's cost inside a traced
step, its reader, and the new cells run through a tiny copy of the
benchmark."""

from __future__ import annotations

import json
import types

import pytest
import torch

from perfbench import run as bench_run
from perfbench.modes.train_step import B1, start_values
from perfbench.reference import render as rr
from perfbench.reference import scene as rs
from perfbench.reference import train as rt
from perfbench.tests import tiny
from skele_raytracer_tpu_torch.models import train
from skele_raytracer_tpu_torch.ops.cuda import pathtrace
from skele_raytracer_tpu_torch.scene.types import leaf_items, replace_leaves
from skele_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)
SPHERES2 = (tiny.REPO / "perfbench" / "scenes" / "spheres2.scn").read_text()
TRAFFIC = json.loads((tiny.REPO / "perfbench" / "traffic" /
                      "train-fog.json").read_text())
NAMES = TRAFFIC["trainable"]
MASK32 = 0xFFFFFFFF


def port_scene(text=SPHERES2, parity=False):
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY
    from skele_raytracer_tpu_torch.scene.parser import parse_scene_text

    return parse_scene_text(text).to_scene(PARITY if parity else CLEAN,
                                           device="cpu")


def port_cfg(c: rr.Config):
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig

    return RenderConfig(width=c.width, height=c.height,
                        monte_carlo=c.gillum > 0, num_paths=c.paths,
                        max_depth=c.depth, use_shadows=c.shadows,
                        grid_size=c.jsample,
                        quirks=PARITY if c.parity else CLEAN, backend="torch")


def fog_state():
    """The program's TrainState from the traffic's start, and its mask."""
    ps = port_scene()
    vals = start_values(dict(leaf_items(ps)), TRAFFIC["start"])
    ps = replace_leaves(ps, [vals[n] for n, _ in leaf_items(ps)])
    mask = train.make_trainable_mask(ps, tuple(NAMES))
    return train.init_state(ps, TRAFFIC["lr"], mask), mask


def test_the_configuration_is_the_scene_as_written():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    cfgs = {c["name"]: c for c in bench["configs"]}
    c = json.loads((tiny.REPO / cfgs["spheres2-1080p-clean"]["file"])
                   .read_text())
    parity = json.loads((tiny.REPO / cfgs["spheres2-1080p-parity"]["file"])
                        .read_text())
    assert c["semantics"] == "clean" and c["reduced"] == []
    assert {k: c[k] for k in ("scene", "width", "height", "gillum", "depth",
                              "shadows", "jsample")} == {
        k: parity[k] for k in ("scene", "width", "height", "gillum", "depth",
                               "shadows", "jsample")}
    sc = rs.build(rs.parse(SPHERES2), parity=False)
    assert len(sc.point_lights["colour"]) == 2
    assert len(sc.directional_lights["colour"]) == 2
    assert sc.fog["scattering"].tolist() == [0.5]
    assert sc.fog["absorption"].tolist() == [0.0]
    st = pathtrace._static_kernel_args(port_scene(), port_cfg(
        rr.Config(1920, 1080, False, 16, 2, True)))
    assert st["point_on"] and st["dir_on"] and st["F"] == 1
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["spheres2-1080p-clean-train"]["traffic"] == "train-fog"
    assert cells["spheres2-1080p-clean-frame"]["traffic"] == "frame"


def test_reference_clean_fog_training_step_matches_the_program():
    """Two steps of the program's train_step (plain path) and of the
    reference's, clean, from the fog traffic's start, its four leaves
    trained: losses, first gradients and leaves agree to float32
    rounding, and the fog's leaves have a gradient."""
    c = rr.Config(24, 16, False, 4, 2, True)
    sc = rs.build(rs.parse(SPHERES2), False)
    target = rt.target_frame(sc, c, TRAFFIC["target_seed"])
    sc = sc.with_leaves(start_values(dict(sc.leaves()), TRAFFIC["start"]))
    losses, first, after = rt.follow(sc, c, 41, target, NAMES,
                                     TRAFFIC["lr"], 2, torch.float32)

    state, mask = fog_state()
    leaves = dict(leaf_items(state.scene))
    got, grads = [], None
    for _ in range(2):
        state, loss = train.train_step(state, port_cfg(c), 41, target,
                                       trainable=mask)
        got.append(float(loss))
        if grads is None:
            opt = state.optimizer
            grads = {n: opt.state[leaves[n]]["exp_avg"] / (1 - B1)
                     for n in NAMES}
    for a, b in zip(got, losses):
        assert abs(a - b) <= 1e-6 * abs(b)
    for n in NAMES:
        rows = after[n].shape[0]
        assert torch.allclose(leaves[n].detach()[:rows], after[n], rtol=0,
                              atol=1e-6), n
        assert torch.allclose(grads[n][:rows], first[n], rtol=1e-4,
                              atol=1e-9), n
    for n in ("fog.albedo", "fog.scattering", "point_lights.colour"):
        assert first[n].abs().max() > 0, n


def hand_count(recs, tabs, static):
    """The record counts, one record at a time."""
    K, N = recs.shape
    slots = []
    point = {"tests": 0, "unshadowed": 0}
    direc = {"tests": 0, "unshadowed": 0}
    live_p = [float(v) > 0 for v in tabs[3][:, 6]]
    live_d = [float(v) > 0 for v in tabs[4][:, 6]]
    for k in range(K):
        hits = 0
        for r in recs[k].tolist():
            r &= MASK32
            if not (r >> 8) & 1:
                continue
            hits += 1
            for li, alive in enumerate(live_p):
                if alive:
                    point["tests"] += 1
                    point["unshadowed"] += (r >> (10 + li)) & 1
            for li, alive in enumerate(live_d):
                if alive:
                    direc["tests"] += 1
                    direc["unshadowed"] += (r >> (10 + static["L"] + li)) & 1
        slots.append({"records": N, "hits": hits})
    return {"slots": slots, "point": point, "directional": direc}


def traced_step(c, state, mask, target, key=7):
    """One train_step inside a CPU profiler take: (new state, profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = train.train_step(state, port_cfg(c), key, target,
                                    trainable=mask)
    return state, prof


@pytest.fixture
def fresh_counter(monkeypatch):
    counter = profiling.RecordCounts()
    monkeypatch.setitem(profiling.COUNTERS, "k1.records", counter)
    return counter


def test_k1_records_counter_matches_a_hand_count(fresh_counter):
    """A traced clean step's counter against the records of the same
    frame (the plain K1 with records at the step's key), counted by
    hand; a second traced step replaces the first's counts."""
    c = rr.Config(16, 12, False, 2, 2, True)
    target = torch.zeros(c.height, c.width, 3)
    state, mask = fog_state()
    cfg = port_cfg(c)
    want = []
    for step in range(2):
        scene = state.scene
        with torch.no_grad():
            tabs = pathtrace._pack_tables(scene)
            planes = pathtrace._plane_inputs(cfg, torch.arange(
                c.width * c.height))
            static = pathtrace._static_kernel_args(scene, cfg)
            recs = pathtrace.pathtrace_forward(tabs, planes, 7 + step, static,
                                               records=True)[3]
        want.append(hand_count(recs, tabs, static))
        state, _ = traced_step(c, state, mask, target)
        assert dict(profiling.COUNTERS["k1.records"]) == want[-1]
    got = want[-1]
    assert len(got["slots"]) == 1 + 2 * 1
    assert 0 < sum(s["hits"] for s in got["slots"][1:]) < 2 * 16 * 12
    for kind in ("point", "directional"):
        assert 0 < got[kind]["unshadowed"] < got[kind]["tests"]
    assert got["point"]["tests"] == 2 * sum(s["hits"] for s in got["slots"])


def test_the_counter_adds_no_work_inside_the_traced_step(fresh_counter,
                                                         monkeypatch):
    """Inside the take the step only keeps its records: the operations
    the profiler records in the step are those of a step whose counter
    keeps nothing, and the reductions run once, at the first read after
    the take, with no profiler recording."""
    c = rr.Config(16, 12, False, 2, 2, True)
    target = torch.zeros(c.height, c.width, 3)
    calls = []
    real = pathtrace.record_counts

    def counted(*a):
        calls.append(torch.autograd._profiler_enabled())
        return real(*a)

    monkeypatch.setattr(pathtrace, "record_counts", counted)

    def ops(prof):
        return sorted(e.name for e in prof.events() if e.name.startswith(
            "aten::"))

    state, mask = fog_state()
    _, prof = traced_step(c, state, mask, target)
    with_counter = ops(prof)
    assert calls == [] and fresh_counter._held
    assert len(fresh_counter) == 3 and calls == [False]
    fresh_counter["slots"]
    assert calls == [False]

    monkeypatch.setattr(profiling.RecordCounts, "hold",
                        lambda self, reduce: None)
    state, mask = fog_state()
    _, prof = traced_step(c, state, mask, target)
    assert ops(prof) == with_counter


def test_a_step_outside_a_take_keeps_nothing(fresh_counter):
    c = rr.Config(16, 12, False, 2, 2, True)
    target = torch.zeros(c.height, c.width, 3)
    state, mask = fog_state()
    train.train_step(state, port_cfg(c), 7, target, trainable=mask)
    assert not fresh_counter._held and dict(fresh_counter) == {}


def test_the_counter_sums_the_launches_of_one_step(fresh_counter):
    """Two K1 launches with records in one traced step (a chunked
    frame) add up; the next step starts the count anew."""
    part = {"slots": [{"records": 4, "hits": 3}, {"records": 4, "hits": 1}],
            "point": {"tests": 8, "unshadowed": 5},
            "directional": {"tests": 8, "unshadowed": 2}}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("train.step"):
                fresh_counter.hold(lambda: part)
                fresh_counter.hold(lambda: part)
    assert dict(fresh_counter) == {
        "slots": [{"records": 8, "hits": 6}, {"records": 8, "hits": 2}],
        "point": {"tests": 16, "unshadowed": 10},
        "directional": {"tests": 16, "unshadowed": 4}}


def _reader():
    return bench_run.load_module(tiny.REPO / "perfbench" / "metrics" /
                                 "bounce_miss_share.step.py").read


def test_bounce_miss_share_reads_the_counter(monkeypatch):
    counter = profiling.RecordCounts()
    counter._counts = {"slots": [{"records": 10, "hits": 9},
                                 {"records": 10, "hits": 2},
                                 {"records": 10, "hits": 1}],
                       "point": {"tests": 0, "unshadowed": 0},
                       "directional": {"tests": 0, "unshadowed": 0}}
    monkeypatch.setitem(profiling.COUNTERS, "k1.records", counter)
    run = types.SimpleNamespace(tr=None)
    assert _reader()(run) == pytest.approx(100.0 * 17 / 20)
    counter._counts = {"slots": [{"records": 10, "hits": 9}],
                       "point": {}, "directional": {}}
    assert _reader()(run) is None  # no bounce slot


def test_bounce_miss_share_without_the_counter_gives_none(monkeypatch):
    run = types.SimpleNamespace(tr=None)
    monkeypatch.setitem(profiling.COUNTERS, "k1.records",
                        profiling.RecordCounts())
    assert _reader()(run) is None
    # an earlier tree's program, which has no such counter
    monkeypatch.delitem(profiling.COUNTERS, "k1.records")
    assert _reader()(run) is None


@pytest.fixture(scope="module")
def clean_copy(tmp_path_factory):
    """A tiny copy of the benchmark with the new cells' configuration cut
    to 32x24 at 4 paths, under the new cells' traffic."""
    root = tiny.make_copy(tmp_path_factory.mktemp("bench"))
    c = json.loads((root / "perfbench" / "configs" /
                    "spheres2-1080p-clean.json").read_text())
    c.update(tiny.TINY, name="tiny-clean")
    (root / "perfbench" / "configs" / "tiny-clean.json").write_text(
        json.dumps(c))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny-clean", source="tiny copy",
                                 file="perfbench/configs/tiny-clean.json",
                                 reduced=[], why="CPU tests"))
    for cell, traffic in (("tiny-clean-train", "train-fog"),
                          ("tiny-clean-frame", "frame")):
        bench["workloads"].append(dict(name=cell, config="tiny-clean",
                                       traffic=traffic, chips=1,
                                       why="CPU tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


SEED = "3000000013"


@pytest.mark.parametrize("cell", ["tiny-clean-train", "tiny-clean-frame"])
def test_the_clean_cells_run_correct(clean_copy, cell):
    rc, res, err = tiny.run_cell(clean_copy, ["--workload", cell, "--seed",
                                              SEED, "--seconds", "1",
                                              "--trace", "0"])
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_loss"])
def test_a_planted_fault_in_the_clean_training_cell_is_not_correct(
        clean_copy, fault):
    rc, res, err = tiny.run_cell(
        clean_copy, ["--workload", "tiny-clean-train", "--seed", SEED,
                     "--seconds", "1", "--trace", "0"],
        f"from perfbench import faults\nfaults.plant({fault!r})")
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]

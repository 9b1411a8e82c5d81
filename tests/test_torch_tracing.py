"""The port's recorder of spans and counters (utils/profiling.py) on the
CPU, and the benchmark's readers of it (perfbench/spans.py and the
metrics that read the program's record).

Spans record only inside a profiler, and only the recorded step's (a
profiler's warm-up step records none); they nest as the program's stages
do, for a K1 frame, a wavefront mesh frame on both routes (the plain
versions) and a training step; a new take clears the last; each span holds
its record_function twin's kineto event, within 50 us at each end (one
clock). The kernel modules' LAUNCHES dicts are held in one registry; the
device counters count only inside a frame's or a step's root span. Each
reader gives its number on a hand-built trace and record, and None from a
program without the record.
"""

import collections
import gc
import time
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from perfbench import run as bench_run
from perfbench.tracing import Trace
from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.models import train
from skele_raytracer_tpu_torch.models.renderer import render, render_frames
from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import culled, glue, intersect, lab
from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt
from skele_raytracer_tpu_torch.scene.parser import parse_scene_text
from skele_raytracer_tpu_torch.utils import profiling
from tests.conftest import TEST_SCN
from tests.torch_cases import fused_mesh_scene

ROOT = Path(__file__).resolve().parents[1]
K1_CFG = dict(width=8, height=6, monte_carlo=True, num_paths=2, max_depth=2,
              use_shadows=True, backend="torch", quirks=PARITY)


@pytest.fixture(scope="module")
def spheres():
    return parse_scene_text(TEST_SCN).to_scene(PARITY)


@pytest.fixture(scope="module")
def mesh():
    return fused_mesh_scene(device="cpu")


def taken(fn):
    """fn() run twice under a profiler: a warm-up step, then the recorded
    step; returns (the profiler, the spans kept)."""
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        prof.step()
        fn()
        prof.step()
    return prof, profiling.spans()


def tree(record):
    """Counter of (name, parent's name) over the record; every span's item
    is its root's id."""
    by_id = {s.id: s for s in record}
    for s in record:
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert s.item == root.id and s.end_ns >= s.start_ns
    return collections.Counter(
        (s.name, None if s.parent is None else by_id[s.parent].name)
        for s in record)


def test_spans_off_record_nothing_and_open_no_record_function(
        spheres, monkeypatch):
    cfg = RenderConfig(**K1_CFG)
    before = [s.id for s in profiling.spans()]
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a))
    render(spheres, cfg, 0)
    assert [s.id for s in profiling.spans()] == before and opened == []


def test_k1_frame_spans_nest(spheres):
    cfg = RenderConfig(**K1_CFG)
    _, record = taken(lambda: render(spheres, cfg, 0))
    assert tree(record) == {("render", None): 1, ("k1.tables", "render"): 1,
                            ("k1.planes", "render"): 1,
                            ("launch.k1", "render"): 1}


def test_render_frames_roots_each_frame(spheres):
    cfg = RenderConfig(**K1_CFG)
    _, record = taken(lambda: render_frames(spheres, cfg, [0, 1, 2]))
    assert tree(record)[("render", None)] == 3
    assert tree(record)[("launch.k1", "render")] == 3


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_frame_spans_nest(mesh, fused):
    cfg = RenderConfig(width=8, height=6, monte_carlo=True, num_paths=2,
                       max_depth=2, use_shadows=True, backend="torch",
                       quirks=CLEAN, fused_megakernel=fused)
    _, record = taken(lambda: render(mesh, cfg, 0))
    # one chunk, the primary wave and one bounce; the split route sorts
    # for K3 and for K4 in each wave, the fused route once for K7 (the
    # plain versions launch nothing)
    assert tree(record) == {("render", None): 1, ("chunk", "render"): 1,
                            ("wave", "chunk"): 2,
                            ("sort", "wave"): 2 if fused else 4}
    assert [s.arg for s in record if s.name == "wave"] == [0, 1]


def test_train_step_spans_nest(spheres):
    cfg = RenderConfig(**K1_CFG)
    target = torch.zeros(6, 8, 3)
    mask = train.make_trainable_mask(spheres, ("spheres.diffuse",))
    state = [train.init_state(spheres, 1e-2, mask)]

    def step():
        state[0], _ = train.train_step(state[0], cfg, 0, target,
                                       trainable=mask)

    _, record = taken(step)
    assert tree(record) == {
        ("train.step", None): 1, ("train.loss", "train.step"): 1,
        ("k1.tables", "train.loss"): 1, ("k1.planes", "train.loss"): 1,
        ("launch.k1", "train.loss"): 1, ("train.backward", "train.step"): 1,
        ("launch.k2", "train.backward"): 1, ("train.mask", "train.step"): 1,
        ("train.update", "train.step"): 1}


def test_a_retake_clears_the_earlier_take(spheres):
    cfg = RenderConfig(**K1_CFG)
    _, first = taken(lambda: render(spheres, cfg, 0))
    _, second = taken(lambda: render(spheres, cfg, 1))
    assert len(first) == len(second) == 4
    assert min(s.id for s in second) > max(s.id for s in first)
    assert [s.id for s in profiling.spans()] == [s.id for s in second]


def test_spans_hold_their_record_function_events(spheres):
    """Each span holds its twin's kineto event (the same clock), within
    50 us at each end (the collector is held off: a collection between
    two stamps would measure the collector)."""
    cfg = RenderConfig(**K1_CFG)
    gc.disable()
    try:
        prof, record = taken(lambda: render(spheres, cfg, 0))
    finally:
        gc.enable()
    names = {s.name for s in record}
    twins = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in names and ev.is_user_annotation():
            twins[ev.name()].append((ev.start_ns(),
                                     ev.start_ns() + ev.duration_ns()))
    for s in record:
        start, end = twins[s.name].pop(0)
        assert 0 <= start - s.start_ns <= 50_000, s
        assert 0 <= s.end_ns - end <= 50_000, s


def test_an_exception_closes_its_span():
    with profiling.span("idle"):  # a site that sees no profiler ends a take
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("render"):
                with profiling.span("chunk"):
                    raise ValueError
        with profiling.span("render"):
            pass
    record = profiling.spans()
    assert tree(record) == {("render", None): 2, ("chunk", "render"): 1}


def test_the_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAPACITY", 4)
    rec = profiling.Recorder()
    for i in range(6):
        rec.close(rec.open(f"s{i}"))
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4", "s5"]


@pytest.mark.parametrize("mod", [pt, culled, mk, intersect, lab, glue],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_launches_are_in_the_registry(mod):
    name = mod.__name__.rsplit(".", 1)[1]
    registry = profiling.COUNTERS["launches"]
    assert registry[name] is mod.LAUNCHES
    assert type(mod.LAUNCHES) is dict and mod.LAUNCHES
    assert all(type(v) is int for v in mod.LAUNCHES.values())
    mod.LAUNCHES[next(iter(mod.LAUNCHES))] += 0  # a plain dict's update
    assert set(registry) == {"pathtrace", "culled", "megakernel",
                             "intersect", "lab", "glue"}


def test_cluster_builds_add_their_seconds():
    t = torch.rand(300, 3)
    before = profiling.COUNTERS["scene.clusters_s"]
    t0 = time.perf_counter()
    accel.build_clusters(t, t + 0.1, t + 0.2, torch.ones(300))
    took = time.perf_counter() - t0
    added = profiling.COUNTERS["scene.clusters_s"] - before
    assert 0 < added <= took


def test_walk_totals_sum_this_takes_rows():
    rec = profiling.Recorder()
    assert rec.walk_totals() is None
    rec.close(rec.open("launch.k3"))
    row = rec.walk_row(torch.device("cpu"))
    assert row.tolist() == [0] * 9
    row += torch.arange(9)
    assert rec.walk_totals() == {"k3": {"rays": 0, "live": 1, "pairs": 2},
                                 "k4": {"rays": 3, "live": 4, "pairs": 5},
                                 "k7": {"rays": 6, "live": 7, "pairs": 8}}
    rec.on = False  # a span site saw the profiler off: the next is a take
    rec.close(rec.open("launch.k3"))
    assert rec.walk_totals() is None  # the row has not counted this take
    assert rec.walk_row(torch.device("cpu")).tolist() == [0] * 9


def test_walk_counters_are_off_outside_a_profiler():
    assert profiling.walk_counters(torch.device("cpu"), "k3") is None


@pytest.mark.parametrize("root", profiling.ROOT_SPANS)
def test_walk_counters_count_only_inside_a_root_span(root):
    cpu = torch.device("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.walk_counters(cpu, "k3") is None  # no span open
        with profiling.span("launch.k3"):  # a kernel timed alone
            assert profiling.walk_counters(cpu, "k3") is None
        with profiling.span(root):
            with profiling.span("launch.k7"):
                addr = profiling.walk_counters(cpu, "k7")
        assert profiling.walk_counters(cpu, "k7") is None
    row = profiling.RECORDER.walk_row(cpu)
    assert addr == row.data_ptr() + 8 * 2 * len(profiling.WALK_COUNTS)


# ---------------------------------------------------------------------------
# The benchmark's readers of the record
# ---------------------------------------------------------------------------

MS = 1_000_000  # ns


def _span(name, id, parent, item, start_ms, end_ms, arg=None):
    return profiling.Span(name, id, parent, item, int(1e12 + start_ms * MS),
                          int(1e12 + end_ms * MS), arg)


def _dev(name, start_ms, end_ms):
    return (name, (1e12 + start_ms * MS) * 1e-9, (1e12 + end_ms * MS) * 1e-9,
            True)


K1F, K1T = "void pathtrace_kernel<false, 4>", "void pathtrace_kernel<true, 4>"


def _record():
    """Two K1 frames, a step and two mesh frames (hand-built), the trace
    of their device work, the device counters and the cluster seconds."""
    spans = [
        _span("render", 0, None, 0, 0.0, 2.0),
        _span("launch.k1", 1, 0, 0, 0.5, 0.6),
        _span("render", 2, None, 2, 3.0, 5.0),
        _span("train.step", 3, None, 3, 10.0, 20.0),
        # a mesh frame: 10 ms, of which sorts and launches cover 1 + 2 + 1
        # (two overlapping wrappers count once)
        _span("render", 4, None, 4, 30.0, 40.0),
        _span("chunk", 5, 4, 4, 30.5, 39.5),
        _span("wave", 6, 5, 4, 31.0, 38.0, 0),
        _span("sort", 7, 6, 4, 31.0, 32.0),
        _span("launch.k3", 8, 6, 4, 33.0, 35.0),
        _span("launch.k4", 9, 6, 4, 34.0, 35.0),
        _span("sort", 10, 6, 4, 36.0, 37.0),
        _span("render", 11, None, 11, 50.0, 56.0),
        _span("launch.k7", 12, 11, 11, 51.0, 53.0),
        _span("launch.k1", 13, 2, 2, 3.3, 3.4),
        _span("launch.k1", 14, 3, 3, 11.0, 11.5),
    ]
    # the second frame's K1 starts after the first's would have
    device = [_dev(K1F, 0.8, 1.8), _dev("elementwise", 3.1, 3.2),
              _dev(K1F, 3.5, 4.5), _dev(K1T, 12.0, 13.0)]
    rec = profiling.Recorder()
    rec.spans.extend(spans)
    rec.walk[("cpu", None)] = [torch.tensor(
        [100, 40, 400, 60, 10, 50, 0, 0, 0]), rec.take]
    rec.walk[("cpu", 1)] = [torch.tensor([100, 40, 400, 0, 0, 0, 0, 0, 0]),
                            rec.take]
    return rec, Trace(items=2, window_s=0.1, device=device)


READINGS = {  # metric: value from _record()
    "k1_lead_ms.frame": (0.8 + 0.5) / 2,  # frames at 0 and 3 ms
    "k1_lead_ms.step": 2.0,
    # every frame: the K1 frames' glue is their render less launch.k1
    "glue_ms.mesh": ((2.0 - 0.1) + (2.0 - 0.1) + (10.0 - 4.0)
                     + (6.0 - 2.0)) / 4,
    "live_ray_share.mesh": 100.0 * 80 / 200,  # K3's: K7 counted no rays
    "pairs_per_live_ray.k3": 800 / 80,
    "pairs_per_live_ray.k4": 50 / 10,
    "pairs_per_live_ray.k7": None,  # K7 counted no live ray
    "cluster_build_s": 1.5,
    "graph_share.mesh": 100.0 * 147 / (147 + 3),
    "graph_share.frame": 100.0 * 201 / (201 + 1),
}


def _reader(metric):
    return bench_run.load_module(ROOT / "perfbench" / "metrics" /
                                 f"{metric}.py").read


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_reads_the_record(metric, monkeypatch):
    rec, tr = _record()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    monkeypatch.setitem(profiling.COUNTERS, "scene.clusters_s", 1.5)
    monkeypatch.setitem(profiling.COUNTERS, "wavefront.graph",
                        {"captures": 2, "replays": 147, "eager": 3})
    monkeypatch.setitem(profiling.COUNTERS, "frame.graph",
                        {"captures": 1, "replays": 201, "eager": 1})
    got = _reader(metric)(types.SimpleNamespace(tr=tr))
    want = READINGS[metric]
    assert got == (None if want is None else pytest.approx(want, abs=1e-6))


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_without_a_record_gives_none(metric, monkeypatch):
    _, tr = _record()
    run = types.SimpleNamespace(tr=tr)
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    monkeypatch.setitem(profiling.COUNTERS, "scene.clusters_s", 0.0)
    monkeypatch.setitem(profiling.COUNTERS, "wavefront.graph",
                        {"captures": 0, "replays": 0, "eager": 0})
    monkeypatch.setitem(profiling.COUNTERS, "frame.graph",
                        {"captures": 0, "replays": 0, "eager": 0})
    assert _reader(metric)(run) is None
    # an earlier tree's program, which keeps no record
    for name in ("spans", "walk_totals", "COUNTERS"):
        monkeypatch.delattr(profiling, name)
    assert _reader(metric)(run) is None


@pytest.mark.parametrize("fault", ["early", "unpaired"])
@pytest.mark.parametrize("metric", ["k1_lead_ms.frame", "k1_lead_ms.step"])
def test_k1_lead_reads_nothing_off_the_shared_clock(metric, fault,
                                                    monkeypatch, capsys):
    """A K1 kernel that starts before the launch.k1 span that launched it
    opens, or a K1 kernel without its span, leaves the lead unread."""
    rec, tr = _record()
    if fault == "early":  # the step's K1 starts 0.2 ms before its span
        tr.device[3] = _dev(K1T, 10.8, 13.0)
    else:
        rec.spans.pop()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    assert _reader(metric)(types.SimpleNamespace(tr=tr)) is None
    assert "do not share a clock" in capsys.readouterr().err


def test_the_k7_share_reads_k7_on_the_fused_route(monkeypatch):
    rec, tr = _record()
    rec.walk[("cpu", 1)][0][6:] = torch.tensor([50, 45, 900])
    monkeypatch.setattr(profiling, "RECORDER", rec)
    run = types.SimpleNamespace(tr=tr)
    assert _reader("live_ray_share.mesh")(run) == pytest.approx(90.0)
    assert _reader("pairs_per_live_ray.k7")(run) == pytest.approx(20.0)

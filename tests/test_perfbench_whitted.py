"""test.scn's Whitted frame (the benchmark's `test-1024x768-whitted`
configuration) on the CPU: the program's plain path on the split and
fused routes against the plain Whitted reference
(perfbench/reference/whitted.py), on test.scn and on seeded random scenes
with glass and mirror spheres over a bumpy mesh; the counter
`wavefront.whitted` against a count taken by hand from the frontier, its
cost in an untraced frame, its reader; and the new cells run through a
tiny copy of the benchmark, sound, with a planted fault, and the
bfloat16 control."""

from __future__ import annotations

import collections
import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench import run as bench_run
from perfbench.reference import render as rr
from perfbench.reference import scene as rs
from perfbench.reference import whitted as rw
from perfbench.tests import tiny
from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
from skele_raytracer_tpu_torch.models import integrator
from skele_raytracer_tpu_torch.models.renderer import render
from skele_raytracer_tpu_torch.scene.parser import parse_scene_text
from skele_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)
CONFIG = "test-1024x768-whitted"
CELLS = {"split": "test-1024x768-whitted-split",
         "fused": "test-1024x768-whitted-fused"}
TEST_SCN = (tiny.REPO / "perfbench" / "scenes" / "test.scn").read_text()
TRAFFIC = json.loads((tiny.REPO / "perfbench" / "traffic" /
                      "whitted-split.json").read_text())
LIMITS, TOL = TRAFFIC["compare"]["limits"], TRAFFIC["compare"]["value_tol"]


def random_scene(seed: int, n: int = 24) -> str:
    """A .scn of six spheres (two of glass, ior 1.5; two mirrors; two
    dull), two point lights and a directional one over an n x n height
    field of 2 n^2 triangles (more than 4 clusters), glassy on odd seeds,
    shifted off the camera's axis so that no pixel's ray runs along a
    shared edge."""
    g = np.random.default_rng(seed)
    f = lambda *a: " ".join(f"{float(v):.6g}" for v in a)  # noqa: E731
    lines = ["camera 0 0 -20 0 0 1 0 1 0 30",
             f"background {f(*g.uniform(0, .4, 3))}",
             f"ambient_light {f(*g.uniform(0, .2, 3))}"]
    for _ in range(2):
        lines.append(f"point_light {f(*g.uniform(10, 60, 3))} "
                     f"{f(*g.uniform(-8, 8, 2), g.uniform(-10, 2))}")
    lines.append(f"directional_light {f(*g.uniform(.2, 1, 3))} "
                 f"{f(*g.uniform(-.5, .5, 2), 1)}")
    for k in range(6):
        spec = ([g.uniform(.4, .9)] * 3, [1, 1, 1], g.uniform(0, .3, 3))[k % 3]
        ior = 1.5 if k % 3 == 0 else 1
        lines.append(f"material {f(*g.uniform(0, .1, 3))} "
                     f"{f(*g.uniform(.1, 1, 3))} {f(*spec)} "
                     f"{f(g.uniform(10, 100))} 0 0 0 {ior}")
        lines.append(f"sphere {f(*g.uniform(-7, 7, 2), g.uniform(0, 8))} "
                     f"{f(g.uniform(1, 2.5))}")
    ior = 1.5 if seed % 2 else 1
    lines.append(f"material 0 0 0 {f(*g.uniform(.2, 1, 3))} "
                 f"{f(*g.uniform(.1, .5, 3))} 50 0 0 0 {ior}")
    z = 10 + g.uniform(-0.6, 0.6, (n + 1, n + 1))
    sx, sy = g.uniform(-0.5, 0.5, 2)
    for i in range(n + 1):
        for j in range(n + 1):
            x, y = sx - 14 + 28 * j / n, sy - 14 + 28 * i / n
            lines.append(f"vertex {f(x, y, z[i, j])}")
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            lines += [f"triangle {a} {a + 1} {a + n + 1}",
                      f"triangle {a + 1} {a + n + 2} {a + n + 1}"]
    return "\n".join(lines) + "\n"


def port_cfg(W, H, depth, fused=False):
    return RenderConfig(width=W, height=H, monte_carlo=False,
                        max_depth=depth, use_shadows=True, quirks=CLEAN,
                        backend="torch", fused_megakernel=fused)


def gaps(text, W, H, depth, fused, seed=5):
    """|port - reference| [W H, 3] of the whole frame."""
    cfg = rr.Config(W, H, False, 0, depth, True, 0)
    ref = rw.render_pixels(rs.build(rs.parse(text), False), cfg, seed,
                           torch.arange(W * H))
    ps = parse_scene_text(text).to_scene(CLEAN, device="cpu")
    assert integrator._use_megakernel(ps, port_cfg(W, H, depth, fused)) \
        == fused
    img = render(ps, port_cfg(W, H, depth, fused), seed)
    return (img.reshape(-1, 3) - ref).abs()


def test_the_configuration_is_the_upstream_scene():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}[CONFIG]
    c = json.loads((tiny.REPO / entry["file"]).read_text())
    assert entry["reduced"] == c["reduced"] == []
    assert {k: c[k] for k in ("width", "height", "semantics", "gillum",
                              "depth", "shadows", "jsample")} == dict(
        width=1024, height=768, semantics="clean", gillum=0, depth=3,
        shadows=True, jsample=0)
    assert TEST_SCN == (tiny.REPO / "scenes" / "test.scn").read_text()
    assert "film_resolution 1024 768" in TEST_SCN
    sc = rs.build(rs.parse(TEST_SCN), parity=False)
    assert sc.spheres["center"].shape[0] == 4
    assert sc.triangles["v0"].shape[0] == 1800
    assert sc.spheres["specular"].min() == 0.8
    assert sc.spheres["ior"].tolist() == [1.0] * 4
    cells = {w["name"]: w for w in bench["workloads"]}
    for route, cell in CELLS.items():
        assert cells[cell]["config"] == CONFIG and cells[cell]["chips"] == 1
        traffic = json.loads((tiny.REPO / "perfbench" / "traffic" / (
            cells[cell]["traffic"] + ".json")).read_text())
        assert traffic["mode"] == "whitted_frame"
        assert traffic["render"].get("fused_megakernel", False) == (
            route == "fused")
    ps = parse_scene_text(TEST_SCN).to_scene(CLEAN, device="cpu")
    assert integrator._use_megakernel(ps, port_cfg(1024, 768, 3, True))


def test_the_reference_loads_nothing_of_the_program():
    from perfbench.tests.test_perfbench_nojax import (FORBIDDEN, PROGRAM,
                                                       loaded_after)

    names = loaded_after("import perfbench.reference.whitted")
    assert "torch" in names and not names & (FORBIDDEN | {PROGRAM})


@pytest.mark.parametrize("route", ["split", "fused"])
def test_test_scn_matches_the_reference(route):
    """test.scn at 32x24, depth 3, shadows: the split route agrees with
    the reference to float32 rounding; the fused route within the cell's
    limits (K7's sphere test is the TPU kernel's expanded quadratic,
    whose rounding a sphere's mirror carries into the next waves)."""
    gap = gaps(TEST_SCN, 32, 24, 3, route == "fused")
    if route == "split":
        assert float(gap.max()) <= 1e-5
    assert float((gap > TOL).float().mean()) <= LIMITS["share_off"] / 2
    assert float(gap.mean()) <= LIMITS["mean_gap"] / 10


@pytest.mark.parametrize("route", ["split", "fused"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_scenes_match_the_reference(seed, route):
    """Glass (refraction, and the zero refracted direction past the
    critical angle), mirrors and a glassy or dull mesh of more than 4
    clusters under point and directional lights, at depth 4."""
    text = random_scene(seed)
    ps = parse_scene_text(text).to_scene(CLEAN, device="cpu")
    assert ps.clusters.n_clusters > 4
    counter = profiling.COUNTERS["wavefront.whitted"]
    with profile(activities=[ProfilerActivity.CPU]):
        gap = gaps(text, 32, 24, 4, route == "fused")
    assert counter["refracted"][0] > 0 and all(counter["reflected"][:3])
    sc = rs.build(rs.parse(text), False)
    o, d = rr.camera_rays(sc, rr.Config(32, 24, False), 0,
                          torch.arange(32 * 24), torch.float32)
    kind, index, _, x, n = rr.intersect(sc, rr.Config(32, 24, False), o, d)
    glass = (kind == 1) & (rw.ior_at(sc, kind, index) > 1)
    sentinel = (rw.refraction(rr.normalize(d), n, rw.ior_at(sc, kind, index))
                == 0).all(1)
    assert (glass & sentinel).any() and (glass & ~sentinel).any()
    if route == "split":
        assert float(gap.max()) <= 1e-4
    assert float((gap > TOL).float().mean()) <= LIMITS["share_off"] / 2
    assert float(gap.mean()) <= LIMITS["mean_gap"] / 10


class _Ops(TorchDispatchMode):
    """The aten operations run under it, by name and count."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if not name.startswith("profiler."):  # a span's record_function
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def hand_count(scene, cfg, seed=3):
    """The frontier's counts by depth, summed over the frame's chunks,
    from each wave's live mask and shading, taken around `_shade_hit`
    (a chunk's waves run one after another, depth by depth)."""
    waves = []
    real = integrator._shade_hit

    def kept(*a, **k):
        out = real(*a, **k)
        waves.append((a[6], a[7] > 0, out[3]))
        return out

    integrator._shade_hit = kept
    try:
        render(scene, cfg, seed)
    finally:
        integrator._shade_hit = real
    want = {k: [0] * cfg.max_depth for k in (
        "rows", "live", "shaded", "reflected", "refracted")}
    for i, (d, live, shades) in enumerate(waves):
        want["rows"][d] += live.shape[0]
        want["live"][d] += int(live.sum())
        want["shaded"][d] += int((live & shades).sum())
        if d + 1 < cfg.max_depth:  # the chunk's next wave: the children
            nxt, R = waves[i + 1][1], live.shape[0]
            want["reflected"][d] += int(nxt[:R].sum())
            want["refracted"][d] += int(nxt[R:].sum())
    return want


def test_the_counter_matches_a_hand_count():
    """A traced frame's counter against the hand count of the same frame;
    two traced frames in one take add up; the next take starts anew; a
    frame outside a take counts nothing."""
    ps = parse_scene_text(random_scene(1)).to_scene(CLEAN, device="cpu")
    cfg = port_cfg(16, 12, 4)
    want = hand_count(ps, cfg)
    assert want["rows"] == [192, 384, 768, 1536]
    assert want["refracted"][0] > 0 and want["live"][3] > 0
    counter = profiling.COUNTERS["wavefront.whitted"]
    with profile(activities=[ProfilerActivity.CPU]):
        render(ps, cfg, 3)
    assert dict(counter) == want
    render(ps, cfg, 3)  # outside a take: counts nothing, ends the take
    assert dict(counter) == want
    with profile(activities=[ProfilerActivity.CPU]):
        render(ps, cfg, 3)
        render(ps, cfg, 4)
    assert dict(counter) == {k: [2 * v for v in vals]
                             for k, vals in want.items()}
    render(ps, cfg, 3)
    fused = port_cfg(16, 12, 4, fused=True)
    with profile(activities=[ProfilerActivity.CPU]):
        render(ps, fused, 3)
    assert dict(counter) == hand_count(ps, fused)  # a new take


def test_an_untraced_frame_runs_nothing_more(monkeypatch):
    """Outside a take the frame runs the operations it runs with the
    counter taken out, and never counts; inside one, the counter adds only
    its sums."""
    ps = parse_scene_text(TEST_SCN).to_scene(CLEAN, device="cpu")
    cfg = port_cfg(16, 12, 3)

    def ops(traced=False):
        with _Ops() as mode:
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    render(ps, cfg, 1)
            else:
                render(ps, cfg, 1)
        return mode.ops

    calls = []
    monkeypatch.setattr(profiling, "count_frontier",
                        lambda *a: calls.append(a))
    untraced = ops()
    assert calls == []
    traced = ops(traced=True)
    assert len(calls) == 3
    monkeypatch.setattr(profiling, "counting", lambda: False)
    assert ops() == untraced
    assert ops(traced=True) == untraced
    monkeypatch.undo()
    extra = ops(traced=True) - untraced
    # the sums of each depth's live rows and shading rows, and their add
    # into the zeroed counter rows
    assert set(extra) <= {f"aten.{op}" for op in (
        "mul", "stack", "view", "sum", "add_", "slice",
        "select", "copy_", "zeros", "empty")}, extra
    assert traced  # the dispatch mode saw the frame


def _reader():
    return bench_run.load_module(tiny.REPO / "perfbench" / "metrics" /
                                 "frontier_dead_share.whitted.py").read


def test_the_dead_share_reads_the_counter(monkeypatch):
    run = types.SimpleNamespace(tr=None)
    monkeypatch.setitem(profiling.COUNTERS, "wavefront.whitted",
                        {"rows": [10, 20, 40], "live": [10, 6, 1]})
    assert _reader()(run) == pytest.approx(100.0 * 53 / 70)
    monkeypatch.setitem(profiling.COUNTERS, "wavefront.whitted", {})
    assert _reader()(run) is None  # no frame counted
    # an earlier tree's program, which has no such counter
    monkeypatch.delitem(profiling.COUNTERS, "wavefront.whitted")
    assert _reader()(run) is None


@pytest.fixture(scope="module")
def whitted_copy(tmp_path_factory):
    """A tiny copy of the benchmark with the new configuration cut to
    32x24 under the new cells' traffic, and a CPU twin of each traffic
    that expects no kernel in its trace."""
    root = tiny.make_copy(tmp_path_factory.mktemp("bench"))
    pb = root / "perfbench"
    c = json.loads((pb / "configs" / f"{CONFIG}.json").read_text())
    c.update(width=32, height=24, name="tiny-whitted")
    (pb / "configs" / "tiny-whitted.json").write_text(json.dumps(c))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny-whitted", source="tiny copy",
                                 file="perfbench/configs/tiny-whitted.json",
                                 reduced=[], why="CPU tests"))
    for route in CELLS:
        t = json.loads((pb / "traffic" / f"whitted-{route}.json").read_text())
        t["trace"]["expect"] = {}
        (pb / "traffic" / f"whitted-{route}-cpu.json").write_text(
            json.dumps(t))
        for traffic in (f"whitted-{route}", f"whitted-{route}-cpu"):
            bench["workloads"].append(dict(
                name=f"tiny-{traffic}", config="tiny-whitted",
                traffic=traffic, chips=1, why="CPU tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


SEED = "3000000017"


@pytest.mark.parametrize("route", ["split", "fused"])
def test_the_whitted_cells_run_correct(whitted_copy, route):
    """A traced run of each cell (its CPU twin: the same cell, no kernel
    expected in the trace) is correct and reads the frontier's dead
    share; the planted fault below runs the untraced window."""
    rc, res, err = tiny.run_cell(whitted_copy, [
        "--workload", f"tiny-whitted-{route}-cpu", "--seed", SEED,
        "--seconds", "1", "--trace", "1"])
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["share_off"]["value"] < LIMITS["share_off"]
    share = res["metrics"]["frontier_dead_share.whitted"]
    assert share["unit"] == "%" and 50 < share["value"] < 100
    assert "graph_share.mesh" in res["metrics"]


def test_a_planted_fault_in_a_whitted_cell_is_not_correct(whitted_copy):
    """An answer altered under the timed path of an untraced window."""
    rc, res, err = tiny.run_cell(
        whitted_copy, ["--workload", "tiny-whitted-split", "--seed", SEED,
                       "--seconds", "1", "--trace", "0"],
        "from perfbench import faults\nfaults.plant('answer_altered')")
    assert rc == 0, err
    assert res["attempted"] >= 1
    assert res["correct"] is False, res["checks"]


def test_the_whitted_control_is_not_correct(whitted_copy):
    """The reference in bfloat16 in the program's place fails the limits
    (the mode's own control entry, in process)."""
    from perfbench.modes import whitted_frame

    bench = json.loads((whitted_copy / "BENCHMARK.json").read_text())
    run = bench_run.Run(whitted_copy, bench, "tiny-whitted-split",
                        int(SEED), 0.0, False, "torch")
    nums, failed = whitted_frame.control(run, frames=1)
    assert failed == 1 and nums["share_off"] > LIMITS["share_off"]


@pytest.mark.cuda
def test_replayed_chunks_count_what_eager_chunks_count(monkeypatch):
    """On the card: traced frames whose chunks replay their counting CUDA
    graph (the host rows added by each replay, the live sums by the
    captured adds) count what the same frame counts chunk by chunk
    eagerly, and what the hand count of the frontier gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from skele_raytracer_tpu_torch.models import graphs

    ps = parse_scene_text(TEST_SCN).to_scene(CLEAN, device="cuda")
    cfg = RenderConfig(width=256, height=192, monte_carlo=False, max_depth=3,
                       use_shadows=True, quirks=CLEAN, backend="cuda",
                       rays_per_chunk=1 << 14)  # 12 chunks of 4,096 samples
    counter = profiling.COUNTERS["wavefront.whitted"]

    def traced():
        with profiling.span("off"):  # a span site seen off: a new take
            pass
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            img = render(ps, cfg, 3)
            torch.cuda.synchronize()
        return img, dict(counter)

    graphs.CHUNK_GRAPHS.clear()
    replays = graphs.COUNTS["replays"]
    img, first = traced()  # one chunk eager and captured, 11 replays
    _, second = traced()  # 12 replays
    assert graphs.COUNTS["replays"] - replays == 23
    monkeypatch.setattr(graphs, "replays", lambda *a: False)
    eager_img, eager = traced()
    assert first == second == eager == hand_count(ps, cfg)
    assert first["rows"] == [49152, 98304, 196608]
    assert torch.equal(img, eager_img)
    graphs.CHUNK_GRAPHS.clear()

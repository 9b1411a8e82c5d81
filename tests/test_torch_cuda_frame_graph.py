"""Whole-frame K1 renders replayed from CUDA graphs (models/renderer.py
`render_ids_k1`, models/graphs.py) on the card (marked `cuda`; skipped
where no GPU is visible; run with tests/test_torch_cuda.py's command).

spheres2 at 96x54, 16 paths of depth 2 with shadows, in parity and in
clean semantics (lights, fog). Frames of several seeds replayed from one
graph are each bitwise the eager K1 frame of their seed (K1 reads the
replay's seed from device memory); a progressive frame replays its
equal bands and runs its cut last band eagerly the first time, captured
for the next frame; a sharded frame replays each shard on the card's
resident scene; a frame under autograd and a frame with a debug output
check run eagerly; every frame counts one K1 launch; a traced take of
replayed frames (perfbench's own take) sees one K1 a frame and one
`launch.k1` span in each.
"""

import dataclasses

import pytest
import torch

from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.models import graphs
from skele_raytracer_tpu_torch.models.progressive import render_progressive
from skele_raytracer_tpu_torch.models.renderer import render, render_radiance
from skele_raytracer_tpu_torch.ops.cuda import _build, pathtrace
from skele_raytracer_tpu_torch.parallel import make_mesh, render_sharded
from skele_raytracer_tpu_torch.utils import profiling
from tests.torch_cases import parsed_scene

pytestmark = pytest.mark.cuda

MODES = {"parity": PARITY, "clean": CLEAN}
CFG = dict(width=96, height=54, monte_carlo=True, num_paths=16, max_depth=2,
           use_shadows=True, backend="cuda")
SEEDS = (7, 8, 2**31 + 5)  # the last with the seed word's high bit set


@pytest.fixture(scope="module")
def scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return {mode: parsed_scene("spheres2.scn", q) for mode, q in MODES.items()}


def _cfg(mode, **kw):
    return RenderConfig(quirks=MODES[mode], **dict(CFG, **kw))


def eager_k1_frame(scene, cfg, seed):
    """The frame through K1's wrapper with the seed as an int: no graph."""
    cfg = cfg.resolved()
    H, W = cfg.height, cfg.width
    ids = torch.arange(H * W, dtype=torch.int64, device=cfg.device)
    with torch.no_grad():
        rad = pathtrace.pathtrace_ids(scene, cfg, seed, ids)
    return rad.reshape(H, W, 1, 3).mean(dim=2)


def _counted(fn):
    """(fn()'s result, the change it made to COUNTERS["frame.graph"], the
    K1 launches it counted)."""
    counts = profiling.COUNTERS["frame.graph"]
    before, k1 = dict(counts), pathtrace.LAUNCHES["pathtrace"]
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: counts[k] - before[k] for k in before},
            pathtrace.LAUNCHES["pathtrace"] - k1)


@pytest.mark.parametrize("mode", list(MODES))
def test_seeds_replay_from_one_graph_bitwise(scenes, mode):
    scene, cfg = scenes[mode], _cfg(mode)
    graphs.CHUNK_GRAPHS.clear()
    first, delta, k1 = _counted(lambda: render(scene, cfg, seed=1))
    assert delta == {"captures": 1, "replays": 0, "eager": 1} and k1 == 1
    imgs, delta, k1 = _counted(lambda: [render(scene, cfg, s)
                                        for s in SEEDS])
    assert delta == {"captures": 0, "replays": len(SEEDS), "eager": 0}
    assert k1 == len(SEEDS)
    assert torch.equal(first, eager_k1_frame(scene, cfg, 1))
    for s, img in zip(SEEDS, imgs):
        assert torch.equal(img, eager_k1_frame(scene, cfg, s)), s
    assert not torch.equal(imgs[0], imgs[1])


def test_new_scene_tensors_capture_anew(scenes):
    scene, cfg = scenes["clean"], _cfg("clean")
    want = render(scene, cfg, seed=4)
    moved = scene.to("cpu").to("cuda")  # the same values in new tensors
    img, delta, _ = _counted(lambda: render(moved, cfg, seed=4))
    assert delta == {"captures": 1, "replays": 0, "eager": 1}
    assert torch.equal(img, want)


def test_progressive_frame_replays_its_equal_bands(scenes):
    """16-row bands of a 54-row frame: the first band captures, the next
    two replay, the cut last band (6 rows, a key of its own) runs eagerly
    and captures; the next frame replays every band. One K1 launch a band;
    each frame is the eager frame's, bit for bit."""
    scene, cfg = scenes["parity"], _cfg("parity")
    graphs.CHUNK_GRAPHS.clear()
    for seed, want in ((3, {"captures": 2, "replays": 2, "eager": 2}),
                       (9, {"captures": 0, "replays": 4, "eager": 0})):
        img, delta, k1 = _counted(lambda: render_progressive(
            scene, cfg, seed, band_rows=16))
        assert delta == want and k1 == 4
        assert (img == eager_k1_frame(scene, cfg, seed).cpu().numpy()).all()


def test_sharded_frames_replay_on_the_resident_copy(scenes):
    """A scene held on the CPU, over two shards of the card: both shards
    replay one graph from the second frame; the frame is the eager
    frame's."""
    host, cfg = scenes["clean"].to("cpu"), _cfg("clean")
    mesh = make_mesh([torch.device("cuda", 0)] * 2)
    frame = lambda seed: render_sharded(host, cfg, seed, mesh)
    frame(3)
    img, delta, k1 = _counted(lambda: frame(8))
    assert delta == {"captures": 0, "replays": 2, "eager": 0} and k1 == 2
    assert torch.equal(img, eager_k1_frame(scenes["clean"], cfg, 8))


def _leaf(scene):
    sph = scene.spheres
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        sph, diffuse=sph.diffuse.clone().requires_grad_(True)))


@pytest.mark.parametrize("why", ["autograd", "output_checks"])
def test_declined_frames_run_eagerly(scenes, why):
    """A frame under autograd (K1 with records) or with a debug output
    check runs K1 eagerly, captures nothing, and gives the eager frame."""
    scene, cfg = scenes["parity"], _cfg("parity")
    render(scene, cfg, seed=2)  # a graph for the scene, not taken below
    if why == "autograd":
        learn = _leaf(scene)

        def frame():
            with torch.enable_grad():
                return render_radiance(learn, cfg, 6).detach()
    else:
        def frame():
            checks = [lambda name, outs: None]
            _build.OUTPUT_CHECKS.extend(checks)
            try:
                return render(scene, cfg, 6)
            finally:
                del _build.OUTPUT_CHECKS[-len(checks):]
    records = pathtrace.LAUNCHES["pathtrace_records"]
    img, delta, k1 = _counted(frame)
    assert delta == {"captures": 0, "replays": 0, "eager": 1}
    assert (pathtrace.LAUNCHES["pathtrace_records"] - records, k1) == (
        (1, 0) if why == "autograd" else (0, 1))
    assert torch.equal(img, eager_k1_frame(scene, cfg, 6))


def test_a_traced_take_sees_one_k1_a_replayed_frame(scenes):
    """perfbench's traced take of frames replayed from a graph captured
    before the profiler started: one K1 a frame in the trace, and in each
    frame's `render` span one `launch.graph` and one `launch.k1` (the span
    perfbench's k1_lead_ms pairs with each K1), no `k1.tables`."""
    from perfbench import spans, tracing

    scene, cfg = scenes["parity"], _cfg("parity")
    render(scene, cfg, seed=1)
    seeds = iter(range(100, 200))

    def run_items(n):
        for _ in range(n):
            render(scene, cfg, next(seeds))
            torch.cuda.synchronize()

    (tr, notes), delta, k1 = _counted(lambda: tracing.take(
        run_items, 10, {"pathtrace_kernel<false": 1}))
    assert tr is not None, notes
    assert delta == {"captures": 0, "replays": 11, "eager": 0} and k1 == 11
    record = spans.spans()
    frames = spans.roots(record, "render")
    assert len(frames) == 10
    for frame in frames:
        inside = sorted(s.name for s in record
                        if s.item == frame.id and s is not frame)
        assert inside == ["launch.graph", "launch.k1"]

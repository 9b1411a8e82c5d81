"""The wavefront's chunks replayed from CUDA graphs (models/graphs.py) on
the card (marked `cuda`; skipped where no GPU is visible; run with
tests/test_torch_cuda.py's command).

A replayed frame is bitwise the frame of the eager chunk path
(`render_ids` chunk by chunk, chip_smoke.py `eager_frame`): dragon clean
gillum 16 depth 2 shadows at 160x120 on the split route (K3, K4) and the
fused route (K7), and test.scn's clean Whitted frontier at depth 3; two
seeds replayed from one graph each equal their eager frames; a scene with
new tensors captures anew; a graph released past CAPACITY, or by
`clear`, captures anew and the graphs kept still replay bitwise; a
sharded frame of a scene held elsewhere replays on the card's resident
copy from its second frame; a traced frame's launch counts and device
counters equal the eager frame's.
"""

import pytest
import torch

from chip_smoke import eager_frame, parsed_scene
from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
from skele_raytracer_tpu_torch.models import graphs
from skele_raytracer_tpu_torch.models.renderer import _chunk_samples, render
from skele_raytracer_tpu_torch.ops.cuda import _build
from skele_raytracer_tpu_torch.parallel import make_mesh, render_sharded
from skele_raytracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

MESH = dict(quirks=CLEAN, monte_carlo=True, num_paths=16, max_depth=2,
            use_shadows=True, backend="cuda")
# (scene file, RenderConfig): 160x120 is 4 full chunks of 4,096 samples
# and a cut one; test.scn's Whitted chunk is 16,384 samples (3 a frame)
CASES = {
    "dragon_split": ("dragon.scn", RenderConfig(width=160, height=120,
                                                **MESH)),
    "dragon_fused": ("dragon.scn", RenderConfig(
        width=160, height=120, fused_megakernel=True, **MESH)),
    "testscn_whitted": ("test.scn", RenderConfig(
        width=256, height=192, quirks=CLEAN, max_depth=3, use_shadows=True,
        backend="cuda")),
}


@pytest.fixture(scope="module")
def scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return {name: parsed_scene(name, CLEAN)
            for name in ("dragon.scn", "test.scn")}


def _counted(fn):
    """(fn()'s result, the change it made to COUNTERS["wavefront.graph"])."""
    before = dict(graphs.COUNTS)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: graphs.COUNTS[k] - before[k] for k in before}


@pytest.mark.parametrize("case", list(CASES))
def test_replayed_frame_equals_eager_chunks(scenes, case):
    name, cfg = CASES[case]
    scene = scenes[name]
    render(scene, cfg, seed=3)  # captures, if no graph holds this key yet
    img, delta = _counted(lambda: render(scene, cfg, seed=5))
    full = cfg.width * cfg.height // _chunk_samples(cfg)
    assert delta["captures"] == 0 and delta["replays"] == full
    assert torch.equal(img, eager_frame(scene, cfg, 5))


def test_two_seeds_replay_from_one_graph(scenes):
    name, cfg = CASES["dragon_split"]
    scene = scenes[name]
    render(scene, cfg, seed=1)
    (a, b), delta = _counted(lambda: (render(scene, cfg, seed=21),
                                      render(scene, cfg, seed=22)))
    assert delta["captures"] == 0 and delta["replays"] > 0
    assert not torch.equal(a, b)
    assert torch.equal(a, eager_frame(scene, cfg, 21))
    assert torch.equal(b, eager_frame(scene, cfg, 22))


def test_new_scene_tensors_capture_anew(scenes):
    name, cfg = CASES["dragon_fused"]
    scene = scenes[name]
    want = render(scene, cfg, seed=4)
    moved = scene.to("cpu").to("cuda")  # the same values in new tensors
    img, delta = _counted(lambda: render(moved, cfg, seed=4))
    assert delta["captures"] == 1
    assert torch.equal(img, want)
    _, delta = _counted(lambda: render(moved, cfg, seed=4))
    assert delta["captures"] == 0 and delta["replays"] > 0


def test_released_graph_captures_anew(scenes):
    """Past CAPACITY graphs on the card the least recently used is
    released: its frame captures anew, and every frame, replayed from a
    graph kept through the releases or captured after them, is bitwise
    its eager frame."""
    name, cfg = CASES["dragon_split"]
    scene = scenes[name]
    cfgs = [cfg.replace(height=cfg.height - 8 * i)
            for i in range(graphs.CAPACITY + 1)]
    for c in cfgs:
        render(scene, c, seed=2)
    dev = torch.device("cuda", torch.cuda.current_device())
    assert sum(k[0] == dev for k in graphs.CHUNK_GRAPHS.graphs) \
        == graphs.CAPACITY
    for c, captures in ((cfgs[0], 1), (cfgs[-1], 0), (cfgs[0], 0)):
        img, delta = _counted(lambda: render(scene, c, seed=6))
        assert delta["captures"] == captures and delta["replays"] > 0
        assert torch.equal(img, eager_frame(scene, c, 6))


def test_cleared_graphs_capture_anew(scenes):
    """`clear` releases every graph and its memory pool; the next frame
    captures into a new pool and is bitwise its eager frame."""
    name, cfg = CASES["dragon_fused"]
    scene = scenes[name]
    render(scene, cfg, seed=2)
    graphs.CHUNK_GRAPHS.clear()
    img, delta = _counted(lambda: render(scene, cfg, seed=6))
    assert delta["captures"] == 1
    assert torch.equal(img, eager_frame(scene, cfg, 6))


def _declined(fn):
    """fn() with every replay declined (a debug output check that checks
    nothing): the eager chunks."""
    checks = [lambda name, outs: None]
    _build.OUTPUT_CHECKS.extend(checks)
    try:
        return fn()
    finally:
        del _build.OUTPUT_CHECKS[-len(checks):]


def test_sharded_frames_replay_on_the_resident_copy(scenes):
    """A scene held on the CPU, rendered over two shards on the card: the
    card's copy of it keeps its tensors, so the second frame captures
    nothing; each frame is bitwise the eager sharded frame."""
    name, cfg = CASES["dragon_split"]
    host = scenes[name].to("cpu")
    mesh = make_mesh([torch.device("cuda", 0)] * 2)
    frame = lambda seed: render_sharded(host, cfg, seed, mesh)
    first = frame(3)
    img, delta = _counted(lambda: frame(8))
    per = cfg.width * cfg.height // 2
    chunk = _chunk_samples(cfg)
    assert delta == {"captures": 0, "replays": 2 * (per // chunk),
                     "eager": 2 * (per % chunk > 0)}
    assert torch.equal(first, _declined(lambda: frame(3)))
    assert torch.equal(img, _declined(lambda: frame(8)))


def _take(fn):
    """(fn()'s result, the launches it counted, its device counters) with
    spans recording: fn runs inside a profiler, where `render` is the
    root span and the cluster walks count."""
    with profiling.span("off"):  # a span site seen off: the next is a take
        pass
    launches = profiling.COUNTERS["launches"]
    before = {m: dict(c) for m, c in launches.items()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    counted = {(m, k): n - before[m][k] for m, c in launches.items()
               for k, n in c.items() if n != before[m][k]}
    return out, counted, profiling.walk_totals()


@pytest.mark.parametrize("case", ["dragon_split", "dragon_fused"])
def test_traced_frame_counts_as_the_eager_frame(scenes, case):
    """The first traced frame runs its first chunk eagerly and captures
    the counting graph (a key of its own, beside the untraced graph); it
    and the next traced frame (replays only) count what the eager frame
    counts."""
    name, cfg = CASES[case]
    scene = scenes[name]
    frame = lambda: render(scene, cfg, seed=9)
    frame()  # the untraced graph
    eager, eager_launches, eager_walks = _declined(lambda: _take(frame))
    full = cfg.width * cfg.height // _chunk_samples(cfg)
    for captures in (1, 0):
        (img, launches, walks), delta = _counted(lambda: _take(frame))
        assert delta == {"captures": captures, "replays": full - captures,
                         "eager": 1 + captures}
        assert torch.equal(img, eager)
        assert launches == eager_launches and launches
        assert walks == eager_walks
        assert walks["k7" if cfg.fused_megakernel else "k3"]["rays"] > 0

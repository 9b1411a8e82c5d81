"""The gate of whole-frame K1 renders replayed from CUDA graphs
(models/renderer.py `render_ids_k1`, models/graphs.py), on the CPU.

A frame replays only with ids on a CUDA device, no scene leaf that needs
a gradient and no debug output checks; its graph's key holds the scene's
tensors, the config and the ids' length; a wavefront scene never reaches
the gate. The card's own path (captures,
replays, bitwise frames) is tests/test_torch_cuda_frame_graph.py. Here
the ids stand in for a card's (their device reads "cuda") and the
replay and the eager kernel are recorded, not run. K1's wrapper takes
its seed as an int or a 0-d int64 tensor, bit for bit the same.
"""

import dataclasses
import os
import types

import pytest
import torch

from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.models import graphs, renderer
from skele_raytracer_tpu_torch.ops.cuda import _build, pathtrace
from skele_raytracer_tpu_torch.scene.parser import parse_scene
from skele_raytracer_tpu_torch.utils import profiling

SCENES = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")
CFG = RenderConfig(width=8, height=6, quirks=PARITY, monte_carlo=True,
                   num_paths=2, max_depth=2, use_shadows=True,
                   backend="torch")
N = CFG.width * CFG.height


@pytest.fixture(scope="module")
def spheres():
    return parse_scene(os.path.join(SCENES, "spheres2.scn")).to_scene(PARITY)


def _card_ids(n=N):
    """Stand-in for n sample ids on a card: what the gate and the key read
    of them."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=(n,),
                                 dtype=torch.int64)


@pytest.fixture
def routes(monkeypatch):
    """Records each K1 frame's route: ("replay", kind) for a graph's run,
    "eager" for the kernel's wrapper called directly; with a store of
    graphs of its own."""
    taken = []
    store = graphs.ChunkGraphs()
    monkeypatch.setattr(graphs, "CHUNK_GRAPHS", store)
    monkeypatch.setattr(store, "run", lambda kind, *a: taken.append(
        ("replay", kind)))
    monkeypatch.setattr(pathtrace, "pathtrace_ids",
                        lambda *a: taken.append("eager"))
    return taken, store


def _counts():
    return dict(profiling.COUNTERS["frame.graph"])


def _delta(before):
    return {k: n - before[k] for k, n in _counts().items()}


def _frame_on_card(scene):
    before = _counts()
    renderer.render_ids_k1(scene, CFG, 3, _card_ids())
    return _delta(before)


def test_a_card_frame_goes_to_the_frame_graph(spheres, routes):
    taken, _ = routes
    with torch.no_grad():
        delta = _frame_on_card(spheres)
    assert taken == [("replay", graphs.FRAME)]
    # run() counts its own replays and captures; the gate counts nothing
    assert delta == {"captures": 0, "replays": 0, "eager": 0}


def _needs_grad(scene):
    sph = scene.spheres
    leaf = sph.diffuse.clone().requires_grad_(True)
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        sph, diffuse=leaf))


def _checked(fn):
    checks = [lambda name, outs: None]
    _build.OUTPUT_CHECKS.extend(checks)
    try:
        return fn()
    finally:
        del _build.OUTPUT_CHECKS[-len(checks):]


@pytest.mark.parametrize("why", ["autograd", "output_checks"])
def test_the_gate_declines_to_eager(spheres, routes, why):
    """Under an autograd leaf or with a debug output check the frame runs
    the kernel eagerly and counts as eager."""
    taken, _ = routes
    if why == "autograd":
        with torch.enable_grad():
            delta = _frame_on_card(_needs_grad(spheres))
    else:
        with torch.no_grad():
            delta = _checked(lambda: _frame_on_card(spheres))
    assert taken == ["eager"]
    assert delta == {"captures": 0, "replays": 0, "eager": 1}


def test_the_gate_declines_cpu_tensors_uncounted(spheres, monkeypatch):
    """A CPU frame runs the plain version: no graph, nothing counted in
    `frame.graph`."""
    store = graphs.ChunkGraphs()
    monkeypatch.setattr(graphs, "CHUNK_GRAPHS", store)
    ids = torch.arange(N, dtype=torch.int64)
    with torch.no_grad():
        before = _counts()
        out = renderer.render_ids_k1(spheres, CFG, 3, ids)
        delta = _delta(before)
        want = pathtrace.pathtrace_ids(spheres, CFG, 3, ids)
    assert torch.equal(out, want)
    assert delta == {"captures": 0, "replays": 0, "eager": 0}
    assert not store.graphs


def test_a_wavefront_config_never_reaches_the_gate(spheres, monkeypatch):
    """spheres2 in clean Whitted (no paths) streams through the wavefront:
    K1's gate is not asked."""
    monkeypatch.setattr(renderer, "render_ids_k1", lambda *a: pytest.fail(
        "a wavefront frame reached the K1 gate"))
    cfg = RenderConfig(width=8, height=6, quirks=CLEAN, max_depth=2,
                       use_shadows=True, backend="torch")
    scene = parse_scene(os.path.join(SCENES, "spheres2.scn")).to_scene(CLEAN)
    assert not pathtrace.use_pathtrace(scene, cfg)
    with torch.no_grad():
        out = renderer.render_ids_chunked(scene, cfg, 3, torch.arange(N))
    assert out.shape == (N, 3)


def test_frame_key_holds_what_a_capture_bakes_in(spheres):
    """The same scene, config and length key alike; another length (a cut
    band), the same values in other tensors or another config key apart,
    and no frame's key is a chunk's."""
    ids = _card_ids()
    key = graphs.ChunkGraphs.frame_key(spheres, CFG, ids)
    assert key == graphs.ChunkGraphs.frame_key(spheres, CFG, _card_ids())
    assert key != graphs.ChunkGraphs.frame_key(spheres, CFG, _card_ids(7))
    assert key != graphs.ChunkGraphs.frame_key(_copied(spheres), CFG, ids)
    assert key != graphs.ChunkGraphs.frame_key(
        spheres, CFG.replace(width=9), ids)
    assert key != graphs.ChunkGraphs.key(spheres, CFG, ids)


def _copied(scene):
    """The scene with every tensor leaf copied (the same values)."""
    from skele_raytracer_tpu_torch.scene.types import (
        replace_leaves,
        scene_leaves,
    )

    return replace_leaves(scene, [t.clone() for t in scene_leaves(scene)])


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_k1_takes_a_tensor_seed_bit_for_bit(mode):
    """pathtrace_forward's plain version with the seed as a 0-d int64
    tensor gives the int seed's planes, high bit set or not."""
    quirks = PARITY if mode == "parity" else CLEAN
    scene = parse_scene(os.path.join(SCENES, "spheres2.scn")).to_scene(
        quirks)
    cfg = CFG.replace(quirks=quirks)
    tabs = pathtrace._pack_tables(scene)
    planes = pathtrace._plane_inputs(cfg, torch.arange(N))
    static = pathtrace._static_kernel_args(scene, cfg)
    for seed in (5, 2**31 + 7):
        want = pathtrace.pathtrace_forward(tabs, planes, seed, static)
        got = pathtrace.pathtrace_forward(
            tabs, planes, torch.tensor(seed, dtype=torch.int64), static)
        assert all(torch.equal(a, b) for a, b in zip(got, want))

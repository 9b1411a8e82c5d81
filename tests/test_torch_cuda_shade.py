"""The split route's hit-shading kernels G3 and G4 (ops/cuda/glue.py,
csrc/shade_math.cuh) on the card (marked `cuda`; skipped where no GPU is
visible; run with tests/test_torch_cuda.py's command).

- `_shade_hit` through G3, K4 and G4 against its tensor code on the same
  rays (the route forced off): the hit record, the material, shades and
  miss bitwise, the direct term within 4 ulp; on dragon's primary and
  bounce waves (4,096 and 65,536 rays, the split cell's shapes) clean and
  parity, test.scn clean with and without shadows, the 128-sphere scene in
  both modes, tests/conftest.py's scene in parity, and rays that miss or
  are dead.
- A frame of the split dragon cell (640x480 clean gillum 16, replayed from
  its chunks' graphs) against the same frame through the tensor code: no
  value off by more than 1e-4; a traced frame's device counters (the rays,
  live rays and cluster pairs of K3 and K4) equal the tensor code's.
- A split chunk launches G3 and G4 twice each (one wave 0, one bounce) and
  counts two `kernel` waves in `wavefront.shade`, none `eager`; a fused
  chunk none of either.
- A mesh gradient (autograd) takes the tensor code: no G3 or G4 launch,
  `eager` waves only, and the gradient of the tensor code.
"""

import dataclasses

import numpy as np
import pytest
import torch

from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.models import graphs, integrator
from skele_raytracer_tpu_torch.models.renderer import (
    _chunk_samples,
    render,
    render_ids_chunked,
)
from skele_raytracer_tpu_torch.ops.cuda import glue
from skele_raytracer_tpu_torch.scene.parser import parse_scene_text
from skele_raytracer_tpu_torch.utils import profiling
from tests.torch_cases import (
    TEST_SCN,
    eager_frame,
    lit_dragon,
    many_sphere_scene,
    mesh_waves,
    parsed_scene,
    ulp_gap,
)

pytestmark = pytest.mark.cuda

SHADE = profiling.COUNTERS["wavefront.shade"]
DIRECT_ULPS = 4
MESH = dict(quirks=CLEAN, monte_carlo=True, num_paths=16, max_depth=2,
            use_shadows=True, backend="cuda")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _scene(name, quirks):
    if name == "many128":
        return many_sphere_scene(128, device="cuda")
    if name == "conftest":
        return parse_scene_text(TEST_SCN).to_scene(quirks, device="cuda")
    return parsed_scene(name, quirks)


@pytest.fixture(scope="module")
def waves(cuda):
    cache = {}

    def get(name, quirks, paths, n):
        key = (name, quirks.triangles_shade_black, paths, n)
        if key not in cache:
            scene = _scene(name, quirks)
            ids = torch.arange(150_000, 150_000 + n, device="cuda")
            cache[key] = scene, mesh_waves(scene, quirks, 640, 480, ids,
                                           paths)
        return cache[key]
    return get


def _cfg(quirks, shadows=True, paths=4):
    return RenderConfig(width=640, height=480, quirks=quirks,
                        monte_carlo=True, num_paths=paths, max_depth=2,
                        use_shadows=shadows, backend="cuda")


def tensor_code(monkeypatch):
    """The split route's tensor code on the card, from here on."""
    monkeypatch.setattr(integrator, "_shade_kernels", lambda *a: False)


def assert_kernels_match(monkeypatch, scene, cfg, o, d, live):
    bounce = 0 if live is None else 1
    before, shade = dict(glue.LAUNCHES), dict(SHADE)
    got = integrator._shade_hit(scene, cfg, 0, o, d, None, bounce, live)
    assert glue.LAUNCHES["shade_hit"] == before["shade_hit"] + 1
    assert glue.LAUNCHES["shade_direct"] == before["shade_direct"] + 1
    assert SHADE == dict(shade, kernel=shade["kernel"] + 1)
    with monkeypatch.context() as mp:
        tensor_code(mp)
        want = integrator._shade_hit(scene, cfg, 0, o, d, None, bounce, live)
    (hw, mw, dw, sw, xw), (hg, mg, dg, sg, xg) = want, got
    for name, a, b in [*zip(hw._fields, hw, hg), *zip(mw._fields, mw, mg),
                       ("shades", sw, sg), ("miss", xw, xg)]:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))
    assert not dw.isnan().any()
    assert int(ulp_gap(dw, dg).max()) <= DIRECT_ULPS
    return hw


CASES = [
    # (scene, quirks, shadows, paths, samples)
    ("dragon.scn", CLEAN, True, 16, 4096),
    ("dragon.scn", PARITY, True, 16, 4096),
    ("test.scn", CLEAN, True, 4, 1024),
    ("test.scn", CLEAN, False, 4, 1024),
    ("many128", CLEAN, True, 4, 1024),
    ("many128", PARITY, True, 4, 1024),
    ("conftest", PARITY, True, 4, 1024),
]


@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize(
    "name,quirks,shadows,paths,n", CASES,
    ids=[f"{c[0].split('.')[0]}-"
         f"{'parity' if c[1].triangles_shade_black else 'clean'}"
         f"{'' if c[2] else '-noshadows'}" for c in CASES])
def test_kernels_match_the_tensor_code(monkeypatch, waves, name, quirks,
                                       shadows, paths, n, wave):
    scene, w = waves(name, quirks, paths, n)
    o, d, *rest = w[wave]
    live = rest[0] if rest else None
    hits = assert_kernels_match(monkeypatch, scene,
                                _cfg(quirks, shadows, paths), o, d, live)
    dead = name == "dragon.scn" and quirks is PARITY and wave == "bounce"
    assert bool((hits.kind > 0).any()) != dead


def test_missed_and_dead_rays_match(monkeypatch, waves):
    scene, w = waves("test.scn", CLEAN, 4, 1024)
    o, d = w["primary"]
    o, d = torch.cat([o, o]), torch.cat([d, -d])
    g = torch.Generator(device="cuda").manual_seed(7)
    live = (torch.rand(o.shape[0], device="cuda", generator=g) > 0.33).float()
    hits = assert_kernels_match(monkeypatch, scene, _cfg(CLEAN), o, d, live)
    n = o.shape[0] // 2
    assert bool((hits.kind[n:] == 0).all()) and bool((hits.kind[:n] > 0).any())


def test_split_cell_frame_equals_the_tensor_codes(monkeypatch, cuda):
    """dragon 640x480 clean gillum 16 depth 2 shadows, replayed: its 150
    split waves all `kernel` in `wavefront.shade`, none `eager`, and the
    frame against the tensor code's run chunk by chunk: no value off by
    more than 1e-4 (the benchmark's `share_off` 0)."""
    scene = parsed_scene("dragon.scn", CLEAN)
    cfg = RenderConfig(width=640, height=480, **MESH)
    with monkeypatch.context() as mp:
        tensor_code(mp)
        want = eager_frame(scene, cfg, 71)
    render(scene, cfg, seed=70)  # captures, if no graph holds this key yet
    shade = dict(SHADE)
    got = render(scene, cfg, seed=71)
    chunks = 640 * 480 // _chunk_samples(cfg.resolved())
    assert chunks == 75
    assert SHADE == dict(kernel=shade["kernel"] + 2 * chunks,
                         eager=shade["eager"])
    off = ((got - want).abs() > 1e-4).float().mean().item()
    assert off == 0.0, (off, (got - want).abs().max().item())


def _take(fn):
    """fn()'s result and the device counters of a take around it."""
    with profiling.span("off"):  # a span site seen off: the next is a take
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    return out, profiling.walk_totals()


def test_k3_and_k4_walk_the_tensor_codes_rays(monkeypatch, cuda):
    """A traced split frame counts in K3's and K4's device rows what the
    tensor code's frame counts: the same rays reach the same kernels."""
    scene = parsed_scene("dragon.scn", CLEAN)
    cfg = RenderConfig(width=160, height=120, **MESH)
    frame = lambda: render(scene, cfg, seed=9)
    with monkeypatch.context() as mp:
        tensor_code(mp)
        want, want_walks = _take(frame)
        # a graph's key does not name the route: drop the tensor code's
        graphs.CHUNK_GRAPHS.clear()
    frame()
    got, walks = _take(frame)
    assert walks["k3"] == want_walks["k3"] and walks["k4"] == want_walks["k4"]
    assert walks["k4"]["live"] > 0
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("route", ["split", "fused"])
def test_a_chunk_shades_each_wave_in_one_launch_of_each(cuda, route):
    scene = parsed_scene("dragon.scn", CLEAN)
    cfg = RenderConfig(width=160, height=120,
                       fused_megakernel=route == "fused", **MESH)
    render(scene, cfg, seed=50)  # captures, if no graph holds this key yet
    before, shade = dict(glue.LAUNCHES), dict(SHADE)
    render(scene, cfg, seed=51)
    torch.cuda.synchronize()
    res = cfg.resolved()
    chunks = -(-res.width * res.height * res.samples_per_pixel
               // _chunk_samples(res))
    assert chunks == 5  # 4 replayed, the cut last one eager
    waves = 2 * chunks if route == "split" else 0
    for name in ("shade_hit", "shade_direct"):
        assert glue.LAUNCHES[name] - before[name] == waves
    assert SHADE["kernel"] - shade["kernel"] == waves
    assert SHADE["eager"] == shade["eager"]


def test_a_mesh_gradient_takes_the_tensor_code(monkeypatch, cuda):
    """The lit dragon's vertex gradient (autograd through checkpointed
    chunks): no G3 or G4 launch, every split wave `eager`, and the
    gradient of the tensor code."""
    ids = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        160 * 120, 256, replace=False))).to("cuda")
    cfg = RenderConfig(width=160, height=120, quirks=CLEAN, monte_carlo=True,
                       num_paths=4, max_depth=2, use_shadows=True,
                       backend="cuda")

    def grad():
        scene = lit_dragon("cuda")
        v0 = scene.triangles.v0.clone().requires_grad_(True)
        scene = dataclasses.replace(scene, triangles=dataclasses.replace(
            scene.triangles, v0=v0))
        r = render_ids_chunked(scene, cfg, 0, ids)
        (r * r).sum().backward()
        torch.cuda.synchronize()
        return v0.grad

    before, shade = dict(glue.LAUNCHES), dict(SHADE)
    got = grad()
    assert glue.LAUNCHES["shade_hit"] == before["shade_hit"]
    assert glue.LAUNCHES["shade_direct"] == before["shade_direct"]
    assert SHADE["kernel"] == shade["kernel"] and SHADE["eager"] > shade[
        "eager"]
    with monkeypatch.context() as mp:
        tensor_code(mp)
        want = grad()
    assert float(want.abs().max()) > 0 and torch.equal(got, want)

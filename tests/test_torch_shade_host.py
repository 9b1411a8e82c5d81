"""The split route's hit-shading kernels G3 and G4 (csrc/shade_math.cuh),
built for the host, against the tensor code of `integrator._shade_hit`.

g++ builds csrc/shade_math.cuh (with csrc/glue_math_host.cpp, -O2
-ffp-contract=off) into a small library under build/ whose
`glue_shade_hit_host` and `glue_shade_direct_host` run the kernels' per-ray
functions serially on ops/cuda/glue.py's `ShadeArgs`. Each case runs the
route of the card, `integrator._shade_hit_glue` (the scans, G3, K4 on G3's
shadow rays, G4), with those two in place of the launches and the plain
versions of K3 and K4, against `_shade_hit`'s tensor code on the same rays:
the hit record, the material, shades and miss bit for bit, and the direct
term within 4 ulp (powf against torch.pow).

PyTorch's float32 sqrt on the CPU may be an ulp off (ops/cuda/intersect.py
`sqrt_rn`); on the card it rounds correctly, as the kernels' sqrtf does. So
the tensor code runs here with `geometry._pos_sqrt` correctly rounded.

Cases: dragon clean, a chunk's primary wave and its bounce wave with the
live mask (K3 and K4 on both clusterings); dragon parity; test.scn clean
(spheres, a mesh, a point and a directional light); the 128-sphere scene
in both modes (spheres only: G4's sphere shadow scan); tests/conftest.py's
scene in parity; rays that miss and rays with live 0. The gate:
`_glue_serves` keeps the tensor code for live fog and for triangle shadows
that K4 does not serve (a mesh of 4 clusters or fewer), and the CPU never
takes the kernels.
"""

import ctypes
import shutil

import pytest
import torch

from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.models import integrator
from skele_raytracer_tpu_torch.ops import geometry
from skele_raytracer_tpu_torch.ops.cuda import _build, glue
from skele_raytracer_tpu_torch.ops.cuda.intersect import sqrt_rn
from skele_raytracer_tpu_torch.scene.parser import parse_scene_text
from skele_raytracer_tpu_torch.utils import profiling
from tests.torch_cases import (
    TEST_SCN,
    k5_mesh_scene,
    many_sphere_scene,
    mesh_waves,
    parsed_scene,
    ulp_gap,
)

DIRECT_ULPS = 4


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = _build.build_host("glue_math_host", ["glue_math_host.cpp"])
    for f in (lib.glue_shade_hit_host, lib.glue_shade_direct_host):
        f.argtypes = [ctypes.POINTER(glue.ShadeArgs)]
        f.restype = None
    lib.glue_shade_args_bytes_host.restype = ctypes.c_longlong
    return lib


@pytest.fixture
def host_route(lib, monkeypatch):
    """G3 and G4 launched on the host; the tensor code's sqrt rounded as
    the card's."""

    def run(name, args, device):
        assert device.type == "cpu"
        getattr(lib, f"glue_{name}_host")(ctypes.byref(args))

    def pos_sqrt(x):
        pos = x > 0
        return sqrt_rn(torch.where(pos, x, 1.0)) * pos

    monkeypatch.setattr(glue, "_run_shade", run)
    monkeypatch.setattr(geometry, "_pos_sqrt", pos_sqrt)


def _scene(name, quirks):
    if name == "many128":
        return many_sphere_scene(128)
    if name == "conftest":
        return parse_scene_text(TEST_SCN).to_scene(quirks)
    return parsed_scene(name, quirks, device="cpu")


def _cfg(quirks, shadows=True, paths=4):
    return RenderConfig(width=640, height=480, quirks=quirks,
                        monte_carlo=True, num_paths=paths, max_depth=2,
                        use_shadows=shadows, backend="torch")


@pytest.fixture(scope="module")
def waves():
    """{(scene, mode): (scene, waves)}: each scene's primary wave of 256
    samples and its bounce wave with the live mask (`mesh_waves`)."""
    cache = {}

    def get(name, quirks, paths):
        key = (name, quirks.triangles_shade_black, paths)
        if key not in cache:
            scene = _scene(name, quirks)
            ids = torch.arange(150_000, 150_000 + 256)
            cache[key] = scene, mesh_waves(scene, quirks, 640, 480, ids,
                                           paths)
        return cache[key]
    return get


def assert_route_matches(scene, cfg, o, d, live):
    want = integrator._shade_hit(scene, cfg, 0, o, d, None,
                                 0 if live is None else 1, live)
    before = dict(glue.LAUNCHES)
    got = integrator._shade_hit_glue(scene, cfg, o, d, live)
    assert glue.LAUNCHES["shade_hit"] == before["shade_hit"] + 1
    assert glue.LAUNCHES["shade_direct"] == before["shade_direct"] + 1
    (hw, mw, dw, sw, xw), (hg, mg, dg, sg, xg) = want, got
    for name, a, b in [*zip(hw._fields, hw, hg), *zip(mw._fields, mw, mg),
                       ("shades", sw, sg), ("miss", xw, xg)]:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))
    assert dw.shape == dg.shape and not dw.isnan().any()
    assert int(ulp_gap(dw, dg).max()) <= DIRECT_ULPS
    return hw


CASES = [
    # (scene, quirks, shadows, paths)
    ("dragon.scn", CLEAN, True, 16),
    ("dragon.scn", PARITY, True, 16),
    ("test.scn", CLEAN, True, 4),
    ("test.scn", CLEAN, False, 4),
    ("many128", CLEAN, True, 4),
    ("many128", PARITY, True, 4),
    ("conftest", PARITY, True, 4),
]


@pytest.mark.parametrize("wave", ["primary", "bounce"])
@pytest.mark.parametrize(
    "name,quirks,shadows,paths", CASES,
    ids=[f"{n.split('.')[0]}-"
         f"{'parity' if q.triangles_shade_black else 'clean'}"
         f"{'' if s else '-noshadows'}" for n, q, s, _ in CASES])
def test_kernels_match_the_tensor_code(host_route, waves, name, quirks,
                                       shadows, paths, wave):
    scene, w = waves(name, quirks, paths)
    cfg = _cfg(quirks, shadows, paths)
    assert integrator._glue_serves(scene, cfg)
    o, d, *rest = w[wave]
    live = rest[0] if rest else None
    hits = assert_route_matches(scene, cfg, o, d, live)
    # parity's triangles end every dragon path: its bounce wave is all dead
    dead = name == "dragon.scn" and quirks is PARITY and wave == "bounce"
    assert bool((hits.kind > 0).any()) != dead


def test_missed_and_dead_rays_match(host_route, waves):
    """test.scn's primary rays beside the same rays turned back (every one
    a miss), with a live mask that kills a third of each: K3 misses a dead
    ray, the sphere scan does not, and K4 leaves a dead hit lit."""
    scene, w = waves("test.scn", CLEAN, 4)
    o, d = w["primary"]
    o, d = torch.cat([o, o]), torch.cat([d, -d])
    g = torch.Generator().manual_seed(7)
    live = (torch.rand(o.shape[0], generator=g) > 0.33).float()
    hits = assert_route_matches(scene, _cfg(CLEAN), o, d, live)
    n = o.shape[0] // 2
    assert bool((hits.kind[n:] == 0).all()) and bool((hits.kind[:n] > 0).any())
    # K3 misses a dead ray: some rays of the first half miss by live alone
    assert bool(((live[:n] == 0) & (hits.kind[:n] == 0)).any())


def test_shade_args_layout(lib):
    """The ctypes mirror of ShadeArgs has the C struct's size."""
    assert lib.glue_shade_args_bytes_host() == ctypes.sizeof(glue.ShadeArgs)


@pytest.mark.parametrize("case,serves", [
    ("dragon-clean", True), ("dragon-parity", True),
    ("k5mesh-clean-shadows", False), ("k5mesh-clean-noshadows", True),
    ("conftest-clean-shadows", False), ("conftest-parity", True),
    ("spheres2-clean-fog", False), ("spheres2-parity-zeroed-fog", True),
])
def test_the_kernels_serve_only_what_they_compute(case, serves):
    """Live fog and triangle shadows that K4 does not serve (a mesh of 4
    clusters or fewer: k5_mesh_scene's 700 triangles, conftest's 2) keep
    the tensor code."""
    name, mode, *rest = case.split("-")
    quirks = CLEAN if mode == "clean" else PARITY
    scene = (k5_mesh_scene() if name == "k5mesh"
             else _scene(name + ".scn" if name in ("dragon", "spheres2")
                         else name, quirks))
    if name == "k5mesh":
        assert scene.clusters.n_clusters <= 4 and scene.has_triangles
    if name == "spheres2":
        assert scene.has_fog and scene.fog_zeroed == (mode == "parity")
    cfg = _cfg(quirks, shadows=rest != ["noshadows"])
    assert integrator._glue_serves(scene, cfg) == serves


def test_the_cpu_keeps_the_tensor_code(monkeypatch):
    """On CPU tensors `_shade_hit` runs the tensor code and counts no
    wave in `wavefront.shade` (which counts the card's split waves)."""
    def fail(*args, **kwargs):
        raise AssertionError("the glue kernels ran on the CPU")

    monkeypatch.setattr(integrator, "_shade_hit_glue", fail)
    scene = many_sphere_scene(16)
    cfg = _cfg(CLEAN)
    counts = dict(profiling.COUNTERS["wavefront.shade"])
    o = torch.zeros(64, 3) + torch.tensor([0.0, 3.0, -24.0])
    d = torch.nn.functional.normalize(torch.randn(64, 3), dim=1)
    assert not integrator._shade_kernels(scene, cfg, o, d)
    integrator._shade_hit(scene, cfg, 0, o, d, None, 0)
    assert profiling.COUNTERS["wavefront.shade"] == counts
    assert set(counts) == {"kernel", "eager"}

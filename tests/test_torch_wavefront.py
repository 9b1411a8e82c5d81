"""The port's chunked wavefront (ops/geometry.py, ops/shading.py,
models/integrator.py) against the JAX package's jnp path, on the CPU
through the kernels' plain versions.

Inputs are the same: scenes handed over with scene.convert, rays made by
the JAX package's camera or from a seeded numpy generator. Tolerances:
hit records as tests/test_accel.py's (flags on more than 99.5% of rays);
radiance as tests/test_pathtrace.py's `_compare` (at most 0.5% of values
off by more than 1e-4, frame means within 5e-4): the culled formulation
and the brute-force scan round differently, so a silhouette ray may flip.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import compare
from skele_raytracer_tpu.config import CLEAN as J_CLEAN
from skele_raytracer_tpu.config import PARITY as J_PARITY
from skele_raytracer_tpu.config import RenderConfig as JConfig
from skele_raytracer_tpu.models import integrator as j_integrator
from skele_raytracer_tpu.ops import geometry as j_geometry
from skele_raytracer_tpu.ops.camera import rays_for_ids as j_rays
from skele_raytracer_tpu.scene.parser import parse_scene as j_parse
from skele_raytracer_tpu.scene.parser import parse_scene_text as j_parse_text
from skele_raytracer_tpu.scene.types import make_scene as j_make_scene
from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.models import graphs, integrator
from skele_raytracer_tpu_torch.models.renderer import (
    _chunk_samples,
    render_ids_wavefront,
)
from skele_raytracer_tpu_torch.ops import geometry, shading
from skele_raytracer_tpu_torch.ops.cuda import _build, culled
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)
from tests.conftest import TEST_SCN_FOG, make_mesh_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIRKS = {"parity": (J_PARITY, PARITY), "clean": (J_CLEAN, CLEAN)}


def _scn(name):
    return os.path.join(REPO, "scenes", name)


def k5_mesh_scene(t=700, seed=12):
    """A JAX scene whose mesh (t triangles, at most 4 clusters of 256)
    takes the brute-force kernel K5, plus one sphere and one light."""
    rng = np.random.default_rng(seed)
    mat = dict(ambient=(0.1, 0.1, 0.1), diffuse=(0.6, 0.5, 0.4),
               specular=(0.2, 0.2, 0.2), transmissive=(0, 0, 0), power=8.0,
               ior=1.0)
    tris = []
    for _ in range(t):
        v0 = rng.uniform(-6, 6, 3)
        tris.append(dict(v0=tuple(v0), v1=tuple(v0 + rng.normal(size=3)),
                         v2=tuple(v0 + rng.normal(size=3)), **mat))
    return j_make_scene(
        triangles=tris,
        spheres=[dict(center=(0, -60, 0), radius=50.0, **mat)],
        point_lights=[dict(position=(0, 20, -10), colour=(200, 200, 200))],
        ambient=(0.2, 0.2, 0.2), camera_position=(0, 0, -14),
        camera_direction=(0, 0, 1), camera_up=(0, 1, 0),
        background=(0.05, 0.1, 0.15))


def _jax_scene(name, mode):
    jq = QUIRKS[mode][0]
    if name == "mesh_k3":
        return make_mesh_scene(t=700)  # clusters of 64: the culled route
    if name == "mesh_k5":
        return k5_mesh_scene()
    if name == "fog":
        return j_parse_text(TEST_SCN_FOG).to_scene(jq)
    return j_parse(_scn(name)).to_scene(jq)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] -= 14.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    return o, d


@pytest.mark.parametrize("mode", ["parity", "clean"])
@pytest.mark.parametrize("name", ["mesh_k3", "mesh_k5"])
def test_intersect_matches_jax(name, mode):
    """Both triangle routes, primary (no `live`) and bounce (`live`)
    waves: hit kind, index, t and normal against the JAX jnp scan."""
    jq, tq = QUIRKS[mode]
    jscene = _jax_scene(name, mode)
    tscene = scene_from_numpy(*scene_to_numpy(jscene))
    o, d = _rays(700, 3)
    k3_before = dict(culled.LAUNCHES)
    jh = j_geometry.intersect(jnp.asarray(o), jnp.asarray(d), jscene,
                              quirks=jq)
    for live in (None, torch.ones(700)):
        th = geometry.intersect(torch.from_numpy(o), torch.from_numpy(d),
                                tscene, quirks=tq, live=live)
        kind, jkind = th.kind.numpy(), np.asarray(jh.kind)
        agree = kind == jkind
        assert agree.mean() > 0.995 and (jkind == 2).mean() > 0.2
        same = agree & (kind > 0)
        np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                                   rtol=1e-3, atol=1e-3)
        same = same & np.isclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-4,
                                 atol=1e-4)
        np.testing.assert_array_equal(th.index.numpy()[same],
                                      np.asarray(jh.index)[same])
        np.testing.assert_allclose(th.normal.numpy()[same],
                                   np.asarray(jh.normal)[same], atol=1e-4)
    assert culled.LAUNCHES == k3_before  # CPU tensors launch no kernel


@pytest.mark.parametrize("mode", ["parity", "clean"])
@pytest.mark.parametrize("name", ["mesh_k3", "fog", "dragon.scn"])
def test_direct_illumination_matches_jax(name, mode):
    """Shading of the same hits (the JAX package's), with shadows: the
    culled any-hit route on the mesh, live fog on the fog scene."""
    jq, tq = QUIRKS[mode]
    jscene = _jax_scene(name, mode)
    tscene = scene_from_numpy(*scene_to_numpy(jscene))
    jcfg = JConfig(width=16, height=12, quirks=jq, use_shadows=True,
                   monte_carlo=True, max_depth=2)
    tcfg = RenderConfig(width=16, height=12, quirks=tq, use_shadows=True,
                        monte_carlo=True, max_depth=2, backend="torch")
    ids = np.arange(192, dtype=np.uint32)
    o, d = j_rays(jscene.camera, jcfg, jnp.uint32(5), jnp.asarray(ids))
    shade_hit = jax.jit(j_integrator._shade_hit, static_argnums=(1, 6))
    jh, jm, jdirect, _, _ = shade_hit(jscene, jcfg, jnp.uint32(5), o, d,
                                      jnp.asarray(ids), 0)
    hits = geometry.Hits(*(torch.from_numpy(np.array(x)) for x in jh))
    hits = hits._replace(kind=hits.kind.long(), index=hits.index.long())
    mat = shading.gather_material(tscene, hits.kind, hits.index, quirks=tq)
    for a, b in zip(mat, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fog_u = integrator._fog_uniforms(tscene, tcfg, 5, torch.from_numpy(
        ids.astype(np.int64)), 0)
    prim = hits.point
    if tscene.has_fog and not tscene.fog_zeroed:
        prim = torch.where((hits.kind == 2)[:, None], hits.point,
                           tscene.spheres.center[hits.index.clamp(max=7)])
    direct = shading.direct_illumination(
        hits.point, hits.normal, tscene, mat, prim, tcfg, fog_u,
        live=(hits.kind > 0).float())
    frac, err, mean_diff, ok = compare(direct, torch.from_numpy(
        np.asarray(jdirect)))
    assert ok, (frac, err, mean_diff)
    # dragon in parity has no sphere to shade and a black mesh
    assert (float(direct.abs().sum()) > 0) != (name == "dragon.scn"
                                               and mode == "parity")


WAVEFRONT_CASES = [  # (scene, mode, RenderConfig overrides)
    ("dragon.scn", "parity", dict(max_depth=2, use_shadows=True)),
    ("dragon.scn", "clean", dict(monte_carlo=True, num_paths=4, max_depth=2,
                                 use_shadows=True)),
    ("test.scn", "parity", dict(monte_carlo=True, num_paths=4, max_depth=2,
                                use_shadows=True)),
    ("test.scn", "clean", dict(monte_carlo=True, num_paths=4, max_depth=2,
                               use_shadows=True)),
    ("mesh_k5", "parity", dict(max_depth=2, use_shadows=True)),
    ("mesh_k5", "clean", dict(monte_carlo=True, num_paths=4, max_depth=2,
                              use_shadows=True)),
    ("mesh_k3", "clean", dict(monte_carlo=True, num_paths=2, max_depth=3,
                              use_shadows=True, grid_size=2)),
]


@pytest.mark.parametrize("name,mode,kw", WAVEFRONT_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in WAVEFRONT_CASES])
def test_integrate_linear_matches_jax(name, mode, kw):
    """integrate_linear on the JAX package's camera rays at 16x12. On
    test.scn the JAX reference runs op by op: jitted, XLA fuses the
    Moller-Trumbore products into FMAs and a few of the 1,800 small
    triangles' edge rays flip against either unfused version."""
    jq, tq = QUIRKS[mode]
    jscene = _jax_scene(name, mode)
    tscene = scene_from_numpy(*scene_to_numpy(jscene))
    w, h = 16, 12
    jcfg = JConfig(width=w, height=h, quirks=jq, backend="jnp", **kw)
    tcfg = RenderConfig(width=w, height=h, quirks=tq, backend="torch", **kw)
    n = w * h * jcfg.samples_per_pixel
    ids = np.arange(n, dtype=np.uint32)
    o, d = j_rays(jscene.camera, jcfg, jnp.uint32(3), jnp.asarray(ids))
    ref = j_integrator.integrate_linear
    if name != "test.scn":
        ref = jax.jit(ref, static_argnums=(1,))
    want = ref(jscene, jcfg, jnp.uint32(3), o, d, jnp.asarray(ids))
    got = integrator.integrate_linear(
        tscene, tcfg, 3, torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(d)), torch.from_numpy(ids.astype(np.int64)))
    frac, err, mean_diff, ok = compare(got, torch.from_numpy(np.array(want)))
    assert ok, (frac, err, mean_diff)
    assert got.shape == (n, 3) and float(got.std()) > 0


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_geometry_primitives_match_jax(mode):
    """The plain scans on TEST_SCN (4 spheres, 2 triangles): nearest
    sphere and triangle, the per-pair triangle test, shadow occlusion
    and the clean origin offset, against the JAX package's."""
    jq, tq = QUIRKS[mode]
    jscene = _jax_scene("fog", mode)
    tscene = scene_from_numpy(*scene_to_numpy(jscene))
    rng = np.random.default_rng(7)
    o = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), \
        torch.from_numpy(d)
    js, ts = jscene.spheres, tscene.spheres
    a = j_geometry.nearest_sphere(jo, jd, js.center, js.radius, js.mask,
                                  quirks=jq)
    b = geometry.nearest_sphere(to, td, ts.center, ts.radius, ts.mask,
                                quirks=tq)
    np.testing.assert_array_equal(b.hit.numpy(), np.asarray(a.hit))
    np.testing.assert_array_equal(b.index.numpy(), np.asarray(a.index))
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), rtol=1e-5)
    jt, tt = jscene.triangles, tscene.triangles
    a = j_geometry.nearest_triangle(jo, jd, jt.v0, jt.v1, jt.v2, jt.mask,
                                    quirks=jq)
    b = geometry.nearest_triangle(to, td, tt.v0, tt.v1, tt.v2, tt.mask,
                                  quirks=tq)
    np.testing.assert_array_equal(b.hit.numpy(), np.asarray(a.hit))
    np.testing.assert_array_equal(b.index.numpy(), np.asarray(a.index))
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), rtol=1e-5)
    np.testing.assert_allclose(b.u.numpy(), np.asarray(a.u), atol=1e-5)
    light = rng.normal(size=(500, 3)).astype(np.float32)
    a = j_geometry.shadow_occluded(jo, jnp.asarray(light), jscene, quirks=jq)
    b = geometry.shadow_occluded(to, torch.from_numpy(light), tscene,
                                 quirks=tq)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert 0.05 < b.float().mean() < 0.95
    n = d / np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        geometry.offset_origin(to, torch.from_numpy(n)).numpy(),
        np.asarray(j_geometry.offset_origin(jo, jnp.asarray(n))), atol=1e-6)
    np.testing.assert_allclose(geometry.norm(td).numpy(),
                               np.asarray(j_geometry.norm(jd)), rtol=1e-6)


def test_graph_gate_declines():
    """A chunk replays a CUDA graph only on a CUDA device, without
    autograd, at the captured length and with no debug output checks."""
    cuda = torch.device("cuda")
    assert graphs.replays(cuda, False, 128, 128)
    assert not graphs.replays(torch.device("cpu"), False, 128, 128)
    assert not graphs.replays(cuda, True, 128, 128)
    assert not graphs.replays(cuda, False, 127, 128)
    checks = [lambda name, outs: None]
    try:
        _build.OUTPUT_CHECKS.extend(checks)
        assert not graphs.replays(cuda, False, 128, 128)
    finally:
        del _build.OUTPUT_CHECKS[-len(checks):]
    assert graphs.replays(cuda, False, 128, 128)


def test_wavefront_counts_eager_chunks():
    """Chunks the gate declines (here: on the CPU) run eagerly and count
    as `eager` in COUNTERS["wavefront.graph"], one per chunk; none is
    captured or replayed."""
    from skele_raytracer_tpu_torch.scene.parser import parse_scene
    from skele_raytracer_tpu_torch.utils import profiling

    scene = parse_scene(_scn("spheres1.scn")).to_scene(CLEAN)
    cfg = RenderConfig(width=16, height=24, quirks=CLEAN, monte_carlo=True,
                       num_paths=2, max_depth=2, use_shadows=True,
                       rays_per_chunk=256, backend="torch")
    chunk = _chunk_samples(cfg)
    n = cfg.width * cfg.height
    ids = torch.arange(n, dtype=torch.int64)
    counts = profiling.COUNTERS["wavefront.graph"]
    before = dict(counts)
    with torch.no_grad():
        out = render_ids_wavefront(scene, cfg, 3, ids)
    assert out.shape == (n, 3)
    assert {k: counts[k] - before[k] for k in counts} == {
        "captures": 0, "replays": 0, "eager": -(-n // chunk)}
    assert -(-n // chunk) == 3

"""The nearest-sphere kernel K6 and the fused kernel K7 on the CPU: their
plain versions (ops/cuda/intersect.py `sphere_nearest`, ops/cuda/
megakernel.py `fused_shade`) against the JAX package's Pallas kernels,
which run here in interpret mode, and the kernels' per-ray headers, built
for the host with g++, against the plain versions.

Tolerances:
* K6 vs JAX: tests/test_pallas.py's (hit flags and indices equal, t within
  rtol 2e-5, atol 1e-5).
* K7 vs JAX: tests/test_megakernel.py's, per ray (kind on >= 99.5% of rays,
  index equal where both hit the same kind, t within rtol 1e-5 there,
  direct >= 99.5% of values within rtol 2e-3, atol 2e-4, shadow bits on >=
  99.5% of the rays that hit). XLA sums its products in another order than
  the port and the TPU kernel normalizes with rsqrt, so a grazing ray may
  flip. The JAX kernel ORs a tile's triangle hits into the shadow bits of
  its miss rays too; the port tests triangles only for rays that hit, so
  shadow bits compare on hits.
* Host builds vs plain: bitwise for hits, indices, t and shadow bits;
  direct within 1e-6 of its largest value (powf and PyTorch's pow may
  differ by an ulp).
* The port's own invariances (ray order, the live mask) are exact.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skele_raytracer_tpu.config import CLEAN as J_CLEAN
from skele_raytracer_tpu.config import PARITY as J_PARITY
from skele_raytracer_tpu.ops.pallas import intersect as j_intersect
from skele_raytracer_tpu.ops.pallas import megakernel as j_mk
from skele_raytracer_tpu_torch.config import CLEAN, CLEAN_T_EPS, PARITY
from skele_raytracer_tpu_torch.config import RenderConfig
from skele_raytracer_tpu_torch.models.integrator import _use_megakernel
from skele_raytracer_tpu_torch.ops.cuda import _build, culled
from skele_raytracer_tpu_torch.ops.cuda import intersect as ik
from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)
from tests.conftest import make_mesh_scene
from tests.test_megakernel import _dir_scene

P = ctypes.c_void_p
QUIRKS = {"parity": (J_PARITY, PARITY), "clean": (J_CLEAN, CLEAN)}


def random_spheres(s=24, seed=1):
    """tests/test_pallas.py's spheres: centers in [-8, 8]^3, radii 0.5-3,
    the last two rows masked."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-8, 8, (s, 3)).astype(np.float32)
    r = rng.uniform(0.5, 3.0, (s,)).astype(np.float32)
    m = np.ones((s,), np.float32)
    m[-2:] = 0.0
    return c, r, m


def random_rays(n, seed, radius=10.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-radius, radius, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_sphere_nearest_plain_matches_jax(mode):
    jq, tq = QUIRKS[mode]
    o, d = random_rays(1500, 0)
    arrays = (o, d, *random_spheres())
    jt, jidx, jhit = j_intersect.sphere_nearest(
        *(jnp.asarray(a) for a in arrays), quirks=jq)
    t, idx, hit = ik.sphere_nearest(*(torch.from_numpy(a) for a in arrays),
                                    quirks=tq)
    assert idx.dtype == torch.int64
    jhit = np.asarray(jhit)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_array_equal(idx.numpy()[jhit], np.asarray(jidx)[jhit])
    np.testing.assert_allclose(t.numpy()[jhit], np.asarray(jt)[jhit],
                               rtol=2e-5, atol=1e-5)
    assert np.isinf(t.numpy()[~jhit]).all()
    assert 0.1 < jhit.mean() < 0.9


def test_sphere_first_minimum_and_miss_index():
    """Two spheres at the same distance: the earlier row wins; a ray that
    hits nothing gets row 0 and t = inf."""
    c = torch.tensor([[0.0, 0.0, 5.0], [0.0, 0.0, 5.0], [9.0, 9.0, 9.0]])
    r = torch.tensor([1.0, 1.0, 1.0])
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    for m in (torch.tensor([1.0, 1.0, 1.0]), torch.tensor([0.0, 1.0, 1.0])):
        t, idx, hit = ik.sphere_nearest(o, d, c, r, m, quirks=CLEAN)
        assert hit.tolist() == [True, False]
        assert idx.tolist() == [0 if m[0] > 0 else 1, 0]
        assert float(t[0]) == 4.0 and np.isinf(float(t[1]))


def _host_lib(name, fn, argtypes):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = _build.build_host(name, [f"{name}.cpp"])
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = None
    return lib


@pytest.mark.parametrize("t_clip", [1.0, CLEAN_T_EPS], ids=["parity", "clean"])
def test_host_build_matches_sphere_nearest_plain(t_clip):
    lib = _host_lib("sphere_math_host", "sphere_nearest_host",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [P] * 5)
    o, d = (torch.from_numpy(a) for a in random_rays(3000, 4, 12.0))
    rows = ik.sphere_rows(*(torch.from_numpy(a) for a in
                            random_spheres(300, 2)))
    n, S = o.shape[0], rows.shape[0]
    t = torch.empty(n)
    i = torch.empty(n, dtype=torch.int32)
    lib.sphere_nearest_host(n, S, t_clip, o.data_ptr(), d.data_ptr(),
                            rows.data_ptr(), t.data_ptr(), i.data_ptr())
    pt, pi = ik.sphere_nearest_torch(o, d, rows, t_clip)
    assert torch.equal(t, pt) and torch.equal(i, pi)
    assert 0.2 < (pt < ik.BIG).float().mean() < 0.9


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

FUSED_CASES = [("point_light_shadows", make_mesh_scene, True),
               ("point_light_noshadow", make_mesh_scene, False),
               ("directional_shadows", _dir_scene, True)]


def fused_rays(n=700, seed=17):
    """tests/test_megakernel.py's rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_shade_plain_matches_jax(case):
    _, scene_fn, shadows = case
    jscene = scene_fn()
    scene = scene_from_numpy(*scene_to_numpy(jscene))
    cfg = RenderConfig(quirks=CLEAN, use_shadows=shadows,
                       fused_megakernel=True, backend="torch")
    assert _use_megakernel(scene, cfg)
    o, d = fused_rays()
    want = [np.asarray(x) for x in j_mk.fused_shade(
        jnp.asarray(o), jnp.asarray(d), jscene, shadows)]
    got = [x.numpy() for x in mk.fused_shade(
        torch.from_numpy(o), torch.from_numpy(d), scene, shadows)]
    direct, t, kind, index, unsh = got
    jdirect, jt, jkind, jindex, junsh = want
    same = kind == jkind
    assert same.mean() >= 0.995, f"{(~same).sum()} rays differ in kind"
    both = same & (kind > 0)
    assert 0.1 < both.mean() < 0.9
    np.testing.assert_array_equal(index[both], jindex[both])
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5)
    assert np.isinf(t[kind == 0]).all()
    close = np.isclose(direct[both], jdirect[both], rtol=2e-3, atol=2e-4)
    assert close.mean() >= 0.995, (
        f"{(~close).sum()} direct values differ; max "
        f"{np.abs(direct[both] - jdirect[both]).max()}")
    agree = (unsh[both] == junsh[both]).all(axis=1)
    assert agree.mean() >= 0.995, f"{(~agree).sum()} shadow bits differ"
    if shadows:
        assert 0.05 < unsh[both].mean() < 0.95
    else:
        assert (unsh == 1).all()


def _fused_inputs(scene, n=900, seed=8, live_share=0.6):
    o, d = (torch.from_numpy(a) for a in fused_rays(n, seed))
    rng = np.random.default_rng(seed)
    live = torch.from_numpy((rng.uniform(size=n) < live_share)
                            .astype(np.float32))
    return o, d, live


@pytest.fixture(scope="module")
def fused_host_lib():
    return _host_lib("megakernel_host", "fused_shade_host",
                     [ctypes.c_int] * 9 + [P] * 12)


@pytest.mark.parametrize("scene_fn", [make_mesh_scene, _dir_scene],
                         ids=["point_light", "directional"])
def test_host_build_matches_fused_shade_plain(fused_host_lib, scene_fn):
    scene = scene_from_numpy(*scene_to_numpy(scene_fn()))
    o, d, live = _fused_inputs(scene)
    feats = culled._ray_features10(o, d).contiguous()
    shade, sph, lights, n_point, cnst = mk.pack_tables(scene)
    rec = scene.clusters.rec.reshape(-1, mk.REC).contiguous()
    R, L = feats.shape[0], lights.shape[0]
    for shadows in (True, False):
        for lv in (None, live):
            out = [torch.empty(R, 3), torch.empty(R),
                   torch.empty(R, dtype=torch.int32),
                   torch.empty(R, dtype=torch.int32), torch.empty(R, L)]
            fused_host_lib.fused_shade_host(
                R, 1, rec.shape[0], 1, shade.shape[0], sph.shape[0],
                n_point, L, int(shadows), feats.data_ptr(),
                None if lv is None else lv.data_ptr(), rec.data_ptr(),
                *(x.data_ptr() for x in (shade, sph, lights, cnst)),
                *(x.data_ptr() for x in out))
            plain = mk.fused_shade_torch(feats, lv, scene.clusters.rec, shade,
                                         sph, lights, n_point, cnst,
                                         use_shadows=shadows)
            for name, a, b in zip(("t", "kind", "index", "unsh"), out[1:],
                                  plain[1:]):
                assert torch.equal(a, b), (name, shadows, lv is None)
            err = (out[0] - plain[0]).abs().max().item()
            assert err <= 1e-6 * plain[0].abs().max().item()
            assert 0.1 < (plain[2] > 0).float().mean() < 0.9


def test_live_rays_do_not_depend_on_live_or_order():
    """A live ray's outputs are the same whatever the live mask and the ray
    order; dead rays get the defaults."""
    scene = scene_from_numpy(*scene_to_numpy(make_mesh_scene()))
    o, d, live = _fused_inputs(scene, n=600, seed=3, live_share=0.5)
    base = mk.fused_shade_forward(o, d, scene, use_shadows=True,
                                  reorder=False)
    order, _ = culled._sort_rays(o, d, scene.clusters, CLEAN, None)
    assert not torch.equal(order, torch.arange(600))
    lv = live > 0
    for mask in (live, 1.0 - live):
        keep = mask > 0
        for reorder in (True, False):
            got = mk.fused_shade_forward(o, d, scene, use_shadows=True,
                                         live=mask, reorder=reorder)
            for x, y in zip(base, got):
                assert torch.equal(x[keep], y[keep])
            direct, t, kind, index, unsh = (x[~keep] for x in got)
            assert not direct.any() and torch.isinf(t).all()
            assert not kind.any() and not index.any() and (unsh == 1).all()
    assert 0.1 < (base[2][lv] > 0).float().mean() < 0.9


def test_megakernel_gate():
    """The fused route serves clean mesh scenes of more than 4 clusters
    without fog, and only when asked for."""
    scene = scene_from_numpy(*scene_to_numpy(make_mesh_scene()))
    cfg = RenderConfig(quirks=CLEAN, fused_megakernel=True, backend="torch")
    assert _use_megakernel(scene, cfg)
    assert not _use_megakernel(scene, cfg.replace(fused_megakernel=False))
    assert not _use_megakernel(scene, cfg.replace(quirks=PARITY))
    for quirk in ("near_clip_t_le_1", "reference_triangle_test",
                  "triangles_shade_black", "sphere_only_shadows",
                  "scalar_epsilon_offset"):
        assert not _use_megakernel(scene, cfg.replace(
            quirks=CLEAN.replace(**{quirk: True}))), quirk
    import dataclasses

    assert not _use_megakernel(dataclasses.replace(scene, fog_active=True),
                               cfg)
    assert not _use_megakernel(dataclasses.replace(scene, clusters=None), cfg)
    few = dataclasses.replace(scene, clusters=scene.clusters_fine)
    assert _use_megakernel(few, cfg) == (scene.clusters_fine.n_clusters > 4)

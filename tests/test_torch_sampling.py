"""Sampling and camera layers of the PyTorch port vs the JAX package.

Tolerances: threefry words and uniform draws bitwise equal (the RNG
streams are the renders' identity); tangent frames, to_world and camera
rays within a few float32 ulps (elementwise float ops, possibly in a
different vectorized order, and tan of the fov angle).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skele_raytracer_tpu.config import CLEAN as J_CLEAN
from skele_raytracer_tpu.config import RenderConfig as JConfig
from skele_raytracer_tpu.ops import camera as j_camera
from skele_raytracer_tpu.ops import sampling as j_sampling
from skele_raytracer_tpu.scene.parser import parse_scene as j_parse
from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.ops import camera as t_camera
from skele_raytracer_tpu_torch.ops import sampling as t_sampling
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = np.concatenate([
    np.arange(64, dtype=np.uint32),
    np.random.default_rng(0).integers(0, 2**32, 64, dtype=np.uint64)
    .astype(np.uint32),
    np.array([2**31 - 1, 2**31, 2**32 - 1], np.uint32),
])


def _ulps(a, b):
    """Distance in float32 ulps (0 for equal values, signed zeros equal)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(2**31) - ia, ia)
    ib = np.where(ib < 0, -(2**31) - ib, ib)
    return np.abs(ia - ib)


def assert_ulp_close(a, b, ulps=4, atol=1e-7):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    ok = (_ulps(a, b) <= ulps) | (np.abs(a - b) <= atol)
    assert ok.all(), (
        f"{(~ok).mean():.2%} beyond {ulps} ulps (max |diff| "
        f"{np.abs(a - b).max():.3e})")


def test_threefry2x32_words_bitwise():
    rng = np.random.default_rng(1)
    for _ in range(4):
        k0, k1 = (int(v) for v in rng.integers(0, 2**32, 2, dtype=np.uint64))
        x1 = rng.integers(0, 2**32, IDS.shape, dtype=np.uint64).astype(
            np.uint32)
        j0, j1 = j_sampling.threefry2x32(np.uint32(k0), np.uint32(k1),
                                         jnp.asarray(IDS), jnp.asarray(x1))
        t0, t1 = t_sampling.threefry2x32(
            k0, k1, torch.from_numpy(IDS.astype(np.int64)),
            torch.from_numpy(x1.astype(np.int64)))
        np.testing.assert_array_equal(t0.numpy(), np.asarray(j0, np.int64))
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1, np.int64))


@pytest.mark.parametrize("shape", [(), (2,), (3,), (2, 4)],
                         ids=["scalar", "pair", "odd", "matrix"])
def test_uniform_bitwise(shape):
    ids_t = torch.from_numpy(IDS.astype(np.int64))
    for seed in (0, 7, 2**32 - 1):
        for bounce in (0, 1, 5):
            for purpose in (t_sampling.PURPOSE_JITTER,
                            t_sampling.PURPOSE_PATH, t_sampling.PURPOSE_FOG):
                j = np.asarray(j_sampling.uniform(
                    jnp.uint32(seed), jnp.asarray(IDS), bounce, purpose,
                    shape))
                t = t_sampling.uniform(seed, ids_t, bounce, purpose,
                                       shape).numpy()
                assert t.dtype == np.float32
                np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("shape", [(), (2,), (3,), (2, 4)],
                         ids=["scalar", "pair", "odd", "matrix"])
def test_uniform_tensor_seed_bitwise(shape):
    """A seed given as a 0-d int64 tensor (the static input of a chunk's
    CUDA graph, models/graphs.py) draws the bits of the same int seed, for
    every purpose and bounce; a tensor past 2^32 is masked as an int is."""
    ids_t = torch.from_numpy(IDS.astype(np.int64))
    for seed in (0, 7, 2**32 - 1, 2**32 + 5):
        seed_t = torch.tensor(seed, dtype=torch.int64)
        for bounce in (0, 1, 5):
            for purpose in (t_sampling.PURPOSE_JITTER,
                            t_sampling.PURPOSE_PATH, t_sampling.PURPOSE_FOG):
                want = t_sampling.uniform(seed, ids_t, bounce, purpose, shape)
                got = t_sampling.uniform(seed_t, ids_t, bounce, purpose,
                                         shape)
                assert got.dtype == torch.float32
                assert torch.equal(got, want)


def _normals(n=512):
    rng = np.random.default_rng(2)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:8] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, -1, 0], [1e-8, 1, 0],
             [0.6, 0.6, 0.0], [0, 0, -1], [-1, 1e-9, 0]]
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_tangent_frame_ulp_close():
    n = _normals()
    jpn, jpb = j_sampling.tangent_frame(jnp.asarray(n))
    tpn, tpb = t_sampling.tangent_frame(torch.from_numpy(n))
    assert_ulp_close(tpn.numpy(), np.asarray(jpn))
    assert_ulp_close(tpb.numpy(), np.asarray(jpb))


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_hemisphere_to_world_ulp_close(mode):
    n = _normals()
    rng = np.random.default_rng(3)
    r1, r2 = rng.random((2, n.shape[0])).astype(np.float32)
    jq = JConfig().quirks if mode == "parity" else J_CLEAN
    tq = PARITY if mode == "parity" else CLEAN
    js = j_sampling.uniform_sample_hemi(jnp.asarray(r1), jnp.asarray(r2))
    ts = t_sampling.uniform_sample_hemi(torch.from_numpy(r1),
                                        torch.from_numpy(r2))
    assert_ulp_close(ts.numpy(), np.asarray(js))
    jw = j_sampling.to_world(js, jnp.asarray(n), quirks=jq)
    tw = t_sampling.to_world(ts, torch.from_numpy(n), quirks=tq)
    assert_ulp_close(tw.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("jsample", [0, 5])
@pytest.mark.parametrize("mode", ["parity", "clean"])
@pytest.mark.parametrize("scn", ["spheres1.scn", "spheres2.scn"])
def test_rays_for_ids_ulp_close(scn, mode, jsample):
    quirks = PARITY if mode == "parity" else CLEAN
    jq = JConfig().quirks if mode == "parity" else J_CLEAN
    kw = dict(width=40, height=30, grid_size=jsample)
    jcfg, tcfg = JConfig(quirks=jq, **kw), RenderConfig(quirks=quirks, **kw)
    jscene = j_parse(os.path.join(REPO, "scenes", scn)).to_scene(jq)
    tscene = scene_from_numpy(*scene_to_numpy(jscene))
    n = 40 * 30 * jcfg.samples_per_pixel
    ids = np.arange(n, dtype=np.uint32)
    jo, jd = j_camera.rays_for_ids(jscene.camera, jcfg, jnp.uint32(9),
                                   jnp.asarray(ids))
    to, td = t_camera.rays_for_ids(tscene.camera, tcfg, 9,
                                   torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert_ulp_close(td.numpy(), np.asarray(jd), atol=1e-6)
    assert t_camera.total_rays(tcfg) == j_camera.total_rays(jcfg)
    np.testing.assert_array_equal(
        t_camera.camera_right(tscene.camera).numpy(),
        np.asarray(j_camera.camera_right(jscene.camera)))

"""The mesh kernels' math: the brute-force kernel K5's plain version
against the JAX package's Pallas kernel, and the per-ray header of all
three mesh kernels, built for the host, against the plain versions.

csrc/mesh_math.cuh is `__host__ __device__`; g++ builds it (with
csrc/mesh_math_host.cpp, -O2 -ffp-contract=off) into a small library
under build/ that scans CPU tensors brute force, as the plain versions do.
Both round every operation on its own and sum in the same order, so hits,
indices and occlusion must agree bitwise and t to the bit as well; this
catches indexing faults and float promotions in the header on a machine
with no GPU. The .cu kernels themselves are compared with the plain
versions only on the card (chip_smoke.py).

K5 vs JAX: tests/test_accel.py's tolerance (hit flags on more than 99.5%
of rays, t within 1e-3, indices equal where t agrees to 1e-4).
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
from skele_raytracer_tpu_torch.config import CLEAN, CLEAN_T_EPS, PARITY
from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import _build, culled
from skele_raytracer_tpu_torch.ops.cuda import intersect as k5
from tests.test_torch_accel import random_mesh, random_rays
from tests.test_torch_culled import assert_nearest_agrees

QUIRKS = {"parity": (J_PARITY, PARITY), "clean": (J_CLEAN, CLEAN)}
P = ctypes.c_void_p


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_triangle_nearest_plain_matches_jax(mode):
    jq, tq = QUIRKS[mode]
    v0, v1, v2, m = random_mesh(t=700, seed=9)
    o, d = random_rays(600, 4)
    jt, jidx, jhit, ju, jv = j_intersect.triangle_nearest(
        *(jnp.asarray(a) for a in (o, d, v0, v1, v2, m)), quirks=jq)
    t, idx, hit, u, v = k5.triangle_nearest(
        *(torch.from_numpy(a) for a in (o, d, v0, v1, v2, m)), quirks=tq)
    assert idx.dtype == torch.int64 and int(idx.max()) <= 699
    assert_nearest_agrees(t, idx, hit, jt, jidx, jhit)
    both = (hit.numpy() & np.asarray(jhit)
            & np.isclose(t.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4))
    np.testing.assert_allclose(u.numpy()[both], np.asarray(ju)[both],
                               atol=1e-3)
    np.testing.assert_allclose(v.numpy()[both], np.asarray(jv)[both],
                               atol=1e-3)


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = _build.build_host("mesh_math_host", ["mesh_math_host.cpp"])
    lib.culled_nearest_host.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [P] * 5)
    lib.culled_occluded_host.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [P] * 5)
    lib.triangle_nearest_host.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [P] * 6)
    for f in (lib.culled_nearest_host, lib.culled_occluded_host,
              lib.triangle_nearest_host):
        f.restype = None
    return lib


def _inputs(seed, n=500):
    arrays = random_mesh(t=600, seed=seed)
    mesh = accel.build_clusters(*(torch.from_numpy(a) for a in arrays),
                                cluster_size=128)
    o, d = (torch.from_numpy(a) for a in random_rays(n, seed + 1))
    rng = np.random.default_rng(seed)
    live = torch.from_numpy((rng.uniform(size=n) > 0.2).astype(np.float32))
    bound = torch.from_numpy(rng.uniform(0.5, 25.0, n).astype(np.float32))
    return arrays, mesh, o, d, live, bound


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_host_build_matches_culled_plain_versions(host_lib, mode):
    arrays, mesh, o, d, live, bound = _inputs(3)
    sign = 1.0 if mode == "parity" else -1.0
    clip = mode == "clean"
    feats = culled._ray_features10(o, d).contiguous()
    rec = mesh.rec.reshape(-1, accel.REC).contiguous()
    n, T = feats.shape[0], rec.shape[0]
    for lv in (None, live):
        t = torch.empty(n)
        i = torch.empty(n, dtype=torch.int32)
        host_lib.culled_nearest_host(
            n, 1, T, 1, int(clip), sign, CLEAN_T_EPS, feats.data_ptr(),
            None if lv is None else lv.data_ptr(), rec.data_ptr(),
            t.data_ptr(), i.data_ptr())
        pt, pi = culled.culled_nearest_torch(feats, mesh.rec, lv, sign=sign,
                                             clip=clip)
        assert torch.equal(t, pt) and torch.equal(i, pi)
        assert 0.1 < (t < culled.BIG).float().mean() < 1.0
    t_clip = 1.0 if mode == "parity" else CLEAN_T_EPS
    unbounded = torch.full((n,), culled.BIG)
    for bnd, lv in ((unbounded, None), (bound, live)):
        occ = torch.empty(n)
        host_lib.culled_occluded_host(
            n, 1, T, 1, sign, t_clip, feats.data_ptr(), bnd.data_ptr(),
            None if lv is None else lv.data_ptr(), rec.data_ptr(),
            occ.data_ptr())
        want = culled.culled_occluded_torch(feats, bnd, mesh.rec, lv,
                                            sign=sign, t_clip=t_clip)
        assert torch.equal(occ > 0.5, want)
        assert 0.05 < want.float().mean() < 0.95


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_host_build_matches_triangle_nearest_plain(host_lib, mode):
    arrays, _, o, d, _, _ = _inputs(5)
    sign = 1.0 if mode == "parity" else -1.0
    clip = mode == "clean"
    feats = k5.ray_features(o, d).contiguous()
    rec = k5.pack_triangles(*(torch.from_numpy(a) for a in arrays))
    n, T = feats.shape[0], rec.shape[0]
    out = [torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty(n),
           torch.empty(n)]
    host_lib.triangle_nearest_host(n, T, int(clip), sign, CLEAN_T_EPS,
                                   feats.data_ptr(), rec.data_ptr(),
                                   *(x.data_ptr() for x in out))
    plain = k5.triangle_nearest_torch(feats, rec, sign=sign, clip=clip)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert 0.1 < (out[0] < k5.BIG).float().mean() < 1.0

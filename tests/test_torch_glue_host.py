"""The glue kernels' per-ray math, built for the host, against the int64
tensor code it replaces on the card.

csrc/glue_math.cuh is `__host__ __device__`; g++ builds it (with
csrc/glue_math_host.cpp, -O2 -ffp-contract=off) into a small library under
build/ that runs glue.cu's launchers' loops on CPU tensors, with the
operands the wrappers of ops/cuda/glue.py pass. It must give the plain
versions' bits exactly:

- the sort keys (`culled.footprint_keys_torch`, `megakernel.
  spatial_keys_torch`, the dead-ray key) on random rays and on edge rays
  (direction components 0, -0, +-1e-31, +-1e-30, +-1; origins inside, on
  and outside the mesh box and on the supercluster boxes' corners), for
  both `allow_negative`, on dragon's two clusterings and on a mesh of 8
  clusters (fewer than N_SUPER superclusters), with and without a live
  mask, and with strided o and d;
- the draws (`sampling.uniform`) for an int seed (above 2^32: masked)
  and a 0-d tensor seed, int64 and int32 ids near 2^32, shapes (), (2,),
  (3,) and (L, F, 4, 2).

The kernels themselves are compared with the same plain versions only on
the card (tests/test_torch_cuda_glue.py).
"""

import ctypes
import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from skele_raytracer_tpu_torch.config import CLEAN
from skele_raytracer_tpu_torch.ops import accel, sampling
from skele_raytracer_tpu_torch.ops.cuda import _build, culled, glue, megakernel
from skele_raytracer_tpu_torch.scene.parser import parse_scene

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = _build.build_host("glue_math_host", ["glue_math_host.cpp"])
    lib.glue_sort_keys_host.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 5)
    lib.glue_sort_keys_host.restype = ctypes.c_int
    lib.glue_uniform_host.argtypes = (
        [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_uint] * 3 + [ctypes.c_void_p])
    lib.glue_uniform_host.restype = None
    return lib


@pytest.fixture(scope="module")
def meshes():
    scene = parse_scene(os.path.join(SCENES, "dragon.scn")).to_scene(CLEAN)
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    small = accel.build_clusters(
        torch.from_numpy(v0),
        torch.from_numpy(v0 + rng.normal(0, .5, (500, 3)).astype(np.float32)),
        torch.from_numpy(v0 + rng.normal(0, .5, (500, 3)).astype(np.float32)),
        torch.ones(500), cluster_size=64)
    assert small.n_clusters < accel.N_SUPER < scene.clusters.n_clusters
    return {"dragon": scene.clusters, "dragon_fine": scene.clusters_fine,
            "small": small}


def rays(mesh, n=1500, seed=0):
    """Random rays around the mesh box, then the edge rays: each edge
    direction from each edge origin."""
    lo, hi = mesh.aabb_lo.amin(0), mesh.aabb_hi.amax(0)
    mid, ext = (lo + hi) / 2, (hi - lo) / 2
    g = torch.Generator().manual_seed(seed)
    o = mid + ext * (3 * torch.rand(n, 3, generator=g) - 1.5)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    sc_lo, sc_hi = accel.supercluster_boxes(mesh.aabb_lo, mesh.aabb_hi)
    origins = torch.cat([
        torch.stack([mid, lo, hi, torch.stack([lo[0], mid[1], mid[2]]),
                     mid + 40 * ext, mid - 3 * ext]), sc_lo[:4], sc_hi[:4]])
    comps = [0.0, -0.0, 1e-31, -1e-31, 1e-30, -1e-30, 1.0, -1.0]
    dirs = torch.tensor([c for c in itertools.product(comps, repeat=3)
                         if any(abs(x) == 1.0 for x in c)] + [[0.0] * 3],
                        dtype=torch.float32)
    eo = origins.repeat_interleave(dirs.shape[0], dim=0)
    ed = dirs.repeat(origins.shape[0], 1)
    return torch.cat([o, eo]), torch.cat([d, ed])


def live_mask(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    live = (torch.rand(n, generator=g) > 0.3).float()
    live[::7] = torch.rand(live[::7].shape, generator=g)  # fractional > 0
    return live


def host_keys(lib, o, d, table, live, mode, allow_negative):
    """glue.sort_keys_kernel's launch, on the host."""
    keys = torch.empty(o.shape[0], dtype=torch.int64)
    err = lib.glue_sort_keys_host(
        o.shape[0], mode, (table.shape[0] - 6) // 6, int(allow_negative),
        *o.stride(), *d.stride(), o.data_ptr(), d.data_ptr(),
        None if live is None else live.data_ptr(), table.data_ptr(),
        keys.data_ptr())
    assert err == 0
    return keys


MESHES = ["dragon", "dragon_fine", "small"]


@pytest.mark.parametrize("live", [False, True], ids=["all", "live"])
@pytest.mark.parametrize("allow_negative", [False, True],
                         ids=["clean", "parity"])
@pytest.mark.parametrize("name", MESHES)
def test_footprint_keys_bitwise(lib, meshes, name, allow_negative, live):
    mesh = meshes[name]
    o, d = rays(mesh)
    lv = live_mask(o.shape[0]) if live else None
    table = mesh.sort_table(mirrored=allow_negative)
    got = host_keys(lib, o, d, table, lv, glue.KEY_FOOTPRINT, allow_negative)
    want = culled.footprint_keys_torch(o, d, mesh, lv,
                                       allow_negative=allow_negative)
    assert torch.equal(got, want)
    # every supercluster bit and the dead key occur
    n_sc = min(accel.N_SUPER, mesh.n_clusters)
    bits = (want[want != culled._DEAD] >> (32 - n_sc)).unique()
    assert (bits > 0).any() and ((want == culled._DEAD).any() == live)


@pytest.mark.parametrize("live", [False, True], ids=["all", "live"])
@pytest.mark.parametrize("name", MESHES)
def test_spatial_keys_bitwise(lib, meshes, name, live):
    mesh = meshes[name]
    o, d = rays(mesh, seed=2)
    lv = live_mask(o.shape[0], seed=3) if live else None
    table = mesh.sort_table(mirrored=False)
    got = host_keys(lib, o, d, table, lv, glue.KEY_SPATIAL, False)
    assert torch.equal(got, megakernel.spatial_keys_torch(o, d, mesh, lv))


def test_keys_of_strided_rays_bitwise(lib, meshes):
    """o a column slice of a wider array, d one row expanded (a shadow
    wave's directions toward a directional light)."""
    mesh = meshes["dragon"]
    o, _ = rays(mesh, n=700, seed=4)
    wide = torch.cat([o, o], dim=1)[:, 1:4]
    d = torch.nn.functional.normalize(torch.tensor([[0.3, -1.0, 0.2]]),
                                      dim=1).expand(o.shape[0], 3)
    assert not wide.is_contiguous() and d.stride() == (0, 1)
    table = mesh.sort_table(mirrored=False)
    for mode in (glue.KEY_FOOTPRINT, glue.KEY_SPATIAL):
        got = host_keys(lib, wide, d, table, None, mode, False)
        want = (culled.footprint_keys_torch(wide, d, mesh,
                                            allow_negative=False)
                if mode == glue.KEY_FOOTPRINT
                else megakernel.spatial_keys_torch(wide, d, mesh))
        assert torch.equal(got, want)


@pytest.mark.parametrize("mirrored", [False, True], ids=["tight", "mirrored"])
def test_key_table_is_built_once_per_mesh(meshes, mirrored):
    """The table is a tensor of the mesh, built with it from the boxes the
    int64 keys test, so a move or a resident copy's refresh carries it."""
    mesh = meshes["small"]
    table = mesh.sort_table(mirrored=mirrored)
    assert table is (mesh.key_table_m if mirrored else mesh.key_table)
    assert any(t is table for t in mesh.tensors())
    sc_lo, sc_hi = accel.supercluster_boxes(*mesh.bounds(mirrored=mirrored))
    n_sc = sc_lo.shape[0]
    assert n_sc == mesh.n_clusters and table.shape == (6 * n_sc + 6,)
    assert torch.equal(table[:3 * n_sc], sc_lo.reshape(-1))
    assert torch.equal(table[3 * n_sc:6 * n_sc], sc_hi.reshape(-1))
    assert torch.equal(table[-6:-3], mesh.aabb_lo.amin(0))
    assert torch.equal(table[-3:], mesh.aabb_hi.amax(0))
    moved = mesh.to("meta").sort_table(mirrored=mirrored)
    assert moved.device.type == "meta" and moved.shape == table.shape


def test_keys_reject_a_table_of_no_supercluster(lib):
    o = torch.zeros(4, 3)
    keys = torch.empty(4, dtype=torch.int64)
    for mode, n_sc in ((glue.KEY_FOOTPRINT, 0), (glue.KEY_FOOTPRINT, 17),
                       (2, 4)):
        assert lib.glue_sort_keys_host(4, mode, n_sc, 0, 3, 1, 3, 1,
                                       o.data_ptr(), o.data_ptr(), None,
                                       o.data_ptr(), keys.data_ptr()) == -1


def host_uniform(lib, seed, ids, bounce, purpose, shape):
    """glue.uniform_kernel's launch, on the host."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    out = torch.empty((ids.shape[0], n), dtype=torch.float32)
    seed_t = seed if isinstance(seed, torch.Tensor) else None
    lib.glue_uniform_host(
        ids.shape[0], n, int(ids.dtype == torch.int64), ids.data_ptr(),
        None if seed_t is None else seed_t.data_ptr(),
        0 if seed_t is not None else int(seed) & 0xFFFFFFFF,
        bounce & 0xFFFFFFFF, purpose & 0xFFFFFFFF, out.data_ptr())
    return out.reshape((ids.shape[0],) + tuple(shape))


IDS = torch.cat([torch.arange(40), torch.tensor(
    [2**31 - 1, 2**31, 2**32 - 3, 2**32 - 2, 2**32 - 1])])


@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("seed", ["int", "tensor"])
@pytest.mark.parametrize("shape", [(), (2,), (3,), (2, 3, 4, 2)],
                         ids=["scalar", "pair", "odd", "fog"])
def test_uniform_bitwise(lib, shape, seed, ids_dtype):
    ids = IDS.to(torch.int32) if ids_dtype == torch.int32 else IDS
    s = (2**32 + 2**31 + 977 if seed == "int"
         else torch.tensor(2**31 + 12345, dtype=torch.int64))
    for bounce, purpose in ((0, sampling.PURPOSE_JITTER),
                            (1, sampling.PURPOSE_PATH),
                            (3, sampling.PURPOSE_FOG)):
        got = host_uniform(lib, s, ids, bounce, purpose, shape)
        want = sampling.uniform_torch(s, ids, bounce, purpose, shape)
        assert got.shape == want.shape == (ids.shape[0],) + shape
        assert torch.equal(got, want)
        assert torch.equal(want, sampling.uniform(s, ids, bounce, purpose,
                                                  shape))

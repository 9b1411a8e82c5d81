"""The glue kernels (ops/cuda/glue.py, csrc/glue.cu) on the card (marked
`cuda`; skipped where no GPU is visible; run with tests/test_torch_cuda.py's
command).

- Each kernel is bitwise its int64 twin on the card: the sort keys on
  dragon's waves at 640x480 (the 4,096 primary rays, the 65,536 bounce
  rays and the shadow rays toward the light, whose directions are one row
  expanded), both key modes, both `allow_negative`, both clusterings, with
  and without a live mask, and the order `_sort_rays` takes from them; the
  draws for an int seed and a 0-d device seed, int64 and int32 ids near
  2^32, shapes (), (2,), (3,) and (L, F, 4, 2).
- A captured draw replayed with two seeds gives the twin's draws of each.
  Dragon frames at 160x120 on the split and the fused route, replayed from
  their chunks' graphs with two seeds, are bitwise the frames of the int64
  code run eagerly (the code before the kernels).
- A chunk launches the key kernel once a sort (4 split, 2 fused) and the
  draw kernel once.
"""

import dataclasses

import pytest
import torch

from chip_smoke import eager_frame, mesh_waves, parsed_scene
from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
from skele_raytracer_tpu_torch.models.renderer import _chunk_samples, render
from skele_raytracer_tpu_torch.ops import sampling
from skele_raytracer_tpu_torch.ops.cuda import culled, glue, megakernel
from skele_raytracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

MESH = dict(quirks=CLEAN, monte_carlo=True, num_paths=16, max_depth=2,
            use_shadows=True, backend="cuda")


@pytest.fixture(scope="module")
def dragon():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return parsed_scene("dragon.scn", CLEAN)


@pytest.fixture(scope="module")
def waves(dragon):
    ids = torch.arange(150_000, 150_000 + 4096, device="cuda")
    out = mesh_waves(dragon, CLEAN, 640, 480, ids, 16)
    g = torch.Generator(device="cuda").manual_seed(5)
    o, d = out["primary"]
    out["primary"] = (o, d, (torch.rand(o.shape[0], device="cuda",
                                        generator=g) > 0.2).float())
    o, d, live = out["shadow"]
    out["shadow"] = (o, d[:1].expand(o.shape[0], 3), live)
    return out


@pytest.mark.parametrize("mesh", ["clusters", "clusters_fine"])
@pytest.mark.parametrize("allow_negative", [False, True],
                         ids=["clean", "parity"])
@pytest.mark.parametrize("wave", ["primary", "bounce", "shadow"])
def test_footprint_keys_equal_the_int64_code(dragon, waves, wave,
                                             allow_negative, mesh):
    m = getattr(dragon, mesh)
    o, d, live = waves[wave]
    table = m.sort_table(mirrored=allow_negative)
    for lv in (None, live):
        before = glue.LAUNCHES["sort_keys"]
        got = glue.sort_keys_kernel(o, d, table, lv, mode=glue.KEY_FOOTPRINT,
                                    allow_negative=allow_negative)
        assert glue.LAUNCHES["sort_keys"] == before + 1
        want = culled.footprint_keys_torch(o, d, m, lv,
                                           allow_negative=allow_negative)
        assert torch.equal(got, want)
    q = dataclasses.replace(CLEAN, reference_triangle_test=allow_negative)
    order, lv_sorted = culled._sort_rays(o, d, m, q, live)
    assert torch.equal(order, torch.sort(want, stable=True).indices)
    assert torch.equal(lv_sorted, live[order])


@pytest.mark.parametrize("wave", ["primary", "bounce", "shadow"])
def test_spatial_keys_equal_the_int64_code(dragon, waves, wave):
    m = dragon.clusters
    o, d, live = waves[wave]
    for lv in (None, live):
        got = glue.sort_keys_kernel(o, d, m.sort_table(mirrored=False), lv,
                                    mode=glue.KEY_SPATIAL)
        want = megakernel.spatial_keys_torch(o, d, m, lv)
        assert torch.equal(got, want)
    order, _ = megakernel.sort_rays(o, d, m, live)
    assert torch.equal(order, torch.sort(want, stable=True).indices)


IDS = [0, 1, 2, 3, 4097, 2**31 - 1, 2**31, 2**32 - 3, 2**32 - 2, 2**32 - 1]


@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("seed", ["int", "tensor"])
@pytest.mark.parametrize("shape", [(), (2,), (3,), (2, 3, 4, 2)],
                         ids=["scalar", "pair", "odd", "fog"])
def test_draws_equal_the_int64_code(dragon, shape, seed, ids_dtype):
    ids = torch.cat([torch.arange(70_000, device="cuda"),
                     torch.tensor(IDS, device="cuda")]).to(ids_dtype)
    s = (2**32 + 2**31 + 977 if seed == "int"
         else torch.tensor(2**31 + 12345, device="cuda"))
    before = glue.LAUNCHES["uniform"]
    got = sampling.uniform(s, ids, 1, sampling.PURPOSE_FOG, shape)
    assert glue.LAUNCHES["uniform"] == before + 1
    want = sampling.uniform_torch(s, ids, 1, sampling.PURPOSE_FOG, shape)
    assert got.shape == (ids.shape[0],) + shape
    assert torch.equal(got, want)


def test_captured_draws_follow_the_seed(dragon):
    ids = torch.arange(2**32 - 65_536, 2**32, device="cuda")
    seed = torch.full((), 3, dtype=torch.int64, device="cuda")
    sampling.uniform(seed, ids, 0, sampling.PURPOSE_PATH, (2,))  # loads
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sampling.uniform(seed, ids, 0, sampling.PURPOSE_PATH, (2,))
    for value in (2**31 + 7, 123_456_789):
        seed.fill_(value)
        graph.replay()
        want = sampling.uniform_torch(value, ids, 0, sampling.PURPOSE_PATH,
                                      (2,))
        assert torch.equal(out, want)


def _int64_sort_rays(o, d, mesh, quirks, live):
    keys = culled.footprint_keys_torch(
        o, d, mesh, live, allow_negative=quirks.reference_triangle_test)
    order = torch.sort(keys, stable=True).indices
    return order, None if live is None else live[order]


def _int64_fused_sort_rays(o, d, mesh, live=None):
    order = torch.sort(megakernel.spatial_keys_torch(o, d, mesh, live),
                       stable=True).indices
    return order, None if live is None else live[order].contiguous()


@pytest.mark.parametrize("route", ["split", "fused"])
def test_replayed_frames_equal_the_int64_codes_frames(dragon, route,
                                                      monkeypatch):
    cfg = RenderConfig(width=160, height=120,
                       fused_megakernel=route == "fused", **MESH)
    with monkeypatch.context() as mp:
        mp.setattr(glue, "uniform_kernel", sampling.uniform_torch)
        mp.setattr(culled, "_sort_rays", _int64_sort_rays)
        mp.setattr(megakernel, "sort_rays", _int64_fused_sort_rays)
        want = {seed: eager_frame(dragon, cfg, seed) for seed in (41, 42)}
    render(dragon, cfg, seed=40)  # captures, if no graph holds this key yet
    for seed in (41, 42):
        assert torch.equal(render(dragon, cfg, seed=seed), want[seed])
    assert not torch.equal(want[41], want[42])


@pytest.mark.parametrize("route,sorts", [("split", 4), ("fused", 2)])
def test_a_chunk_launches_keys_once_a_sort_and_draws_once(dragon, route,
                                                          sorts):
    cfg = RenderConfig(width=160, height=120,
                       fused_megakernel=route == "fused", **MESH)
    render(dragon, cfg, seed=50)  # captures, if no graph holds this key yet
    launches = profiling.COUNTERS["launches"]["glue"]
    before = dict(launches)
    render(dragon, cfg, seed=51)
    torch.cuda.synchronize()
    res = cfg.resolved()
    chunks = -(-res.width * res.height * res.samples_per_pixel
               // _chunk_samples(res))
    assert chunks == 5  # 4 replayed, the cut last one eager
    assert launches["sort_keys"] - before["sort_keys"] == sorts * chunks
    assert launches["uniform"] - before["uniform"] == chunks

"""The device counters of the cluster walks on the card (marked `cuda`;
skipped where no GPU is visible; run with tests/test_torch_cuda.py's
command).

On dragon's waves at 640x480 (clean, gillum 16: the primary wave of a
4,096-sample chunk, its bounce wave and the bounce hits' shadow wave),
in footprint order as the wrappers sort them: K3's, K4's and K7's live
rays equal `(live != 0).sum()`, and their (ray, cluster) pairs equal a
host recount of each block's shortlist (the slab tests of
ops/accel.ray_aabb_entry against the widened boxes the kernels read; K7's
shadow walks from its own hits, with the plain version's shadow rays);
the outputs with the counters on are bitwise those with them off. (K3's
and K7's time and registers with the counters off, against an earlier
tree's, are chip_smoke.py's, with --parent-csrc.)
"""

import pytest
import torch

from chip_smoke import dragon_waves
from skele_raytracer_tpu_torch.config import CLEAN, CLEAN_T_EPS
from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import culled
from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
from skele_raytracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
CHUNK = 4096  # samples of one of the dragon cell's chunks
PATHS = 16


@pytest.fixture(scope="module")
def waves():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ids = torch.arange(37 * CHUNK, 38 * CHUNK, device="cuda")
    scene, w = dragon_waves(CLEAN, ids, PATHS)
    return scene, w


def _counted(fn):
    """(fn()'s outputs with the counters off, with them on, the counters'
    totals): on is inside a profiler and a frame's root span, where the
    device counters count."""
    with profiling.span("off"):  # a span site seen off: the next is a take
        off = fn()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("render"):
            on = fn()
        torch.cuda.synchronize()
    return off, on, profiling.walk_totals()


def _block_pairs(hit, alive, lanes):
    """Σ over blocks of (clusters some live ray of the block enters) x
    (its live rays): hit [n, C] the enter test, alive [n] bool."""
    rays = culled.THREADS // lanes
    n, C = hit.shape
    pad = -n % rays
    hit = torch.cat([hit & alive[:, None], hit.new_zeros((pad, C))])
    live = torch.cat([alive, alive.new_zeros(pad)]).reshape(-1, rays)
    shortlist = hit.reshape(-1, rays, C).any(dim=1).sum(dim=1)
    return int((shortlist * live.sum(dim=1)).sum())


def _enters(feats, lo, hi):
    """(entry [n, C], entered with an exit past 0 [n, C]) of the feature
    rows' rays against the boxes, on the CPU (the clean walks' test)."""
    f = feats.cpu()
    ahead, tmin = accel.ray_aabb_entry(f[:, 6:9], f[:, 0:3], lo.cpu(),
                                       hi.cpu())
    return tmin, ahead


def _sorted(o, d, mesh, live):
    lv = None if live is None else (live > 0).float()
    order, lv = culled._sort_rays(o, d, mesh, CLEAN, lv)
    feats = culled._ray_features10(o, d)[order].contiguous()
    return order, feats, lv


@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_k3_counts_its_live_rays_and_shortlists(waves, wave):
    scene, w = waves
    o, d, *live = w[wave]
    live = live[0] if live else None
    mesh = scene.clusters
    _, feats, lv = _sorted(o, d, mesh, live)
    call = lambda: culled.culled_nearest_kernel(feats, mesh, lv,
                                                quirks=CLEAN)
    off, on, tot = _counted(call)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    n = feats.shape[0]
    alive = (torch.ones(n, dtype=torch.bool) if lv is None
             else (lv != 0).cpu())
    assert tot["k3"]["rays"] == n
    assert tot["k3"]["live"] == int(alive.sum())
    lo, hi, _ = mesh.kernel_boxes(mirrored=False)
    _, ahead = _enters(feats, lo, hi)
    assert tot["k3"]["pairs"] == _block_pairs(ahead, alive,
                                              culled.lanes_for(n))
    assert tot["k4"] == tot["k7"] == {"rays": 0, "live": 0, "pairs": 0}


def test_k4_counts_its_live_rays_and_shortlists(waves):
    scene, w = waves
    o, d, live = w["shadow"]
    mesh = scene.clusters
    bound = torch.full((o.shape[0],), culled.BIG, device="cuda")
    order, feats, lv = _sorted(o, d, mesh, live)
    bound = bound[order].contiguous()
    call = lambda: culled.culled_occluded_kernel(
        feats, bound, mesh, lv, quirks=CLEAN, t_clip=CLEAN_T_EPS)
    off, on, tot = _counted(call)
    assert torch.equal(off, on)
    alive = (lv != 0).cpu()
    assert tot["k4"]["rays"] == feats.shape[0]
    assert tot["k4"]["live"] == int(alive.sum()) > 0
    lo, hi, _ = mesh.kernel_boxes(mirrored=False)
    tmin, ahead = _enters(feats, lo, hi)
    hit = ahead & (tmin < bound.cpu()[:, None])
    assert tot["k4"]["pairs"] == _block_pairs(hit, alive,
                                              culled.occluded_lanes())


def _shadow_pairs(feats, alive, outs, tables, lo, hi, lanes):
    """K7's shadow walks recounted on the host: for each light that casts
    shadows, Σ over blocks of (clusters some of the block's hit rays, not
    occluded by a sphere, enters from its shadow origin before its bound)
    x (those rays), from K7's own hits (t, kind, index) and the plain
    version's shadow origins, directions and bounds."""
    shade, sph, lights, n_point, cnst = (
        x.cpu() if torch.is_tensor(x) else x for x in tables)
    f = feats.cpu()
    t, kind, index = (x.cpu() for x in outs[1:4])
    d, o = f[:, 0:3], f[:, 6:9]
    hit = alive & (kind > 0)
    tri = kind == 2
    i_tri = torch.clamp(index.long(), max=shade.shape[0] - 1)
    i_sph = torch.clamp(index.long(), max=sph.shape[0] - 1)
    x = o + d * torch.where(t < mk.BIG, t, 0.0)[:, None]
    n_tri = shade[i_tri][:, 0:3]
    n_tri = torch.where((mk.dot(n_tri, d) > 0)[:, None], -n_tri, n_tri)
    normal = torch.where(tri[:, None], n_tri,
                         mk._unit(x - sph[i_sph][:, 0:3]))
    xn2 = mk.dot(x, x)
    pos = xn2 > 0
    xlen = mk.sqrt_rn(torch.where(pos, xn2, 1.0)) * pos
    sh = x + (CLEAN_T_EPS * (1.0 + xlen))[:, None] * normal
    pairs = 0
    for li in range(lights.shape[0]):
        lr = lights[li]
        if not float(lr[6]) > 0:  # a light that casts no shadow walk
            continue
        if li < n_point:
            v = lr[None, 0:3] - x
            dl = mk.sqrt_rn(torch.clamp(mk.dot(v, v), min=1e-30))
            ldir, bound = v / torch.clamp(dl, min=1e-30)[:, None], dl
        else:
            ldir = lr[None, 0:3].expand(f.shape[0], 3)
            bound = torch.full_like(t, mk.BIG)
        occ = (mk.sphere_t_all_torch(sh, ldir, sph, CLEAN_T_EPS)
               < bound[:, None]).any(dim=1)
        ahead, tmin = accel.ray_aabb_entry(sh, ldir, lo.cpu(), hi.cpu(),
                                           t_clip=CLEAN_T_EPS)
        pairs += _block_pairs(ahead & (tmin < bound[:, None]), hit & ~occ,
                              lanes)
    return pairs


@pytest.mark.parametrize("shadows", [False, True])
def test_k7_counts_its_live_rays_and_shortlists(waves, shadows):
    scene, w = waves
    o, d, live = w["bounce"]
    mesh = scene.clusters
    order, lv = mk.sort_rays(o, d, mesh, (live > 0).float())
    feats = culled._ray_features10(o, d)[order].contiguous()
    tables = mk.pack_tables(scene)
    call = lambda: mk.fused_shade_kernel(feats, lv, mesh, *tables,
                                         use_shadows=shadows)
    off, on, tot = _counted(call)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    n = feats.shape[0]
    alive = (lv != 0).cpu()
    assert tot["k7"]["rays"] == n
    assert tot["k7"]["live"] == int(alive.sum())
    lo, hi, _ = mesh.kernel_boxes(mirrored=False)
    _, ahead = _enters(feats, lo, hi)
    lanes = culled.lanes_for(n)
    want = _block_pairs(ahead, alive, lanes)
    if shadows:  # each light's shadow walk adds its pairs
        shadow = _shadow_pairs(feats, alive, off, tables, lo, hi, lanes)
        assert shadow > 0
        want += shadow
    assert tot["k7"]["pairs"] == want

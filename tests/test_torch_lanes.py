"""The lane split of the cluster-culled kernels K3 (csrc/culled.cu
`nearest_kernel<G, count>`), K4 (csrc/culled.cu `occluded_kernel<G,
count>`) and K7 (csrc/megakernel.cu `fused_kernel<G, shadows, count>`),
on the CPU.

On the card G lanes carry one ray: each tests every G-th record of a staged
cluster (mesh_math.cuh `lane_nearest`, fused_math.cuh `lane_blocks`) and
the group merges its lanes' (t, original index) after each cluster
(`merge_nearest`, a shuffle butterfly). The host builds of the headers
(mesh_math_host.cpp, megakernel_host.cpp; g++ -ffp-contract=off) run that
split serially for G = 1 to 32, butterfly included. Held bitwise
against the plain versions (`culled_nearest_torch`, `fused_shade_torch`):
t, index, kind and shadow bits equal, K7's direct within 1e-6 of its
largest value (powf against PyTorch's pow, as in
tests/test_torch_megakernel.py). Cases: the 1,100-triangle mesh of
chip_smoke.py, samples of dragon's primary and bounce waves, live masks,
and duplicate triangles placed in different lanes (the exact-t tie must
go to the lower original index whichever lane holds it).

K4's lanes each test every G-th record of a cluster and stop at their
first occluder; the group ORs the lanes' bits after each cluster
(mesh_math.cuh `lane_occludes`, the host build `culled_occluded_host`).
Held bitwise against `culled_occluded_torch` for G = 1 to 32 on the
1,100-triangle mesh (bounded and unbounded rays, live masks), on sampled
dragon shadow waves sorted as the wrapper sorts them (dead rays last), and
with each cluster's occluder moved to another lane.

Also the wrappers' launch arithmetic (`culled.launch_shape`), which the C
launchers mirror.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import dragon_waves, lit_dragon, random_rays, synthetic_mesh
from skele_raytracer_tpu_torch.config import CLEAN, CLEAN_T_EPS, PARITY
from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import _build, culled
from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)
from tests.conftest import make_mesh_scene
from tests.test_megakernel import _dir_scene

P = ctypes.c_void_p
GROUPS = [1, 2, 4, 8, 16, 32]
MODES = {"parity": PARITY, "clean": CLEAN}


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    k3 = _build.build_host("mesh_math_host", ["mesh_math_host.cpp"])
    k3.culled_nearest_host.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [P] * 5)
    k3.culled_occluded_host.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [P] * 5)
    k7 = _build.build_host("megakernel_host", ["megakernel_host.cpp"])
    k7.fused_shade_host.argtypes = [ctypes.c_int] * 9 + [P] * 12
    for f in (k3.culled_nearest_host, k3.culled_occluded_host,
              k7.fused_shade_host):
        f.restype = None
    return k3, k7


def lanes_k3(libs, feats, rec, live, G, quirks):
    """(t, index) of the host build's lane split: rec [C, cs, 20]."""
    n = feats.shape[0]
    rec = rec.contiguous()
    t = torch.empty(n)
    i = torch.empty(n, dtype=torch.int32)
    libs[0].culled_nearest_host(
        n, rec.shape[0], rec.shape[1], G,
        int(not quirks.reference_triangle_test),
        1.0 if quirks.reference_triangle_test else -1.0, CLEAN_T_EPS,
        feats.data_ptr(), None if live is None else live.data_ptr(),
        rec.data_ptr(), t.data_ptr(), i.data_ptr())
    return t, i


def plain_k3(o, d, rec, live, quirks):
    """(features, live as float, the plain version's t and index)."""
    feats = culled._ray_features10(o, d).contiguous()
    lv = None if live is None else (live > 0).float().contiguous()
    return (feats, lv) + culled.culled_nearest_torch(
        feats, rec, lv, sign=1.0 if quirks.reference_triangle_test else -1.0,
        clip=not quirks.reference_triangle_test)


def assert_k3_lanes(libs, o, d, rec, live, G, quirks):
    feats, lv, pt, pi = plain_k3(o, d, rec, live, quirks)
    t, i = lanes_k3(libs, feats, rec, lv, G, quirks)
    assert torch.equal(t, pt) and torch.equal(i, pi)
    return pt, pi


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("G", GROUPS)
def test_k3_lanes_match_plain_on_synthetic_mesh(libs, G, mode):
    tris = synthetic_mesh(1100, 9, "cpu")
    o, d, live, _ = random_rays(1500, 4, "cpu")
    for cs in (accel.CLUSTER_SIZE, accel.FINE_CLUSTER_SIZE):
        mesh = accel.build_clusters(*tris, cluster_size=cs)
        for lv in (None, live):
            t, _ = assert_k3_lanes(libs, o, d, mesh.rec, lv, G, MODES[mode])
            assert 0.1 < (t < culled.BIG).float().mean() < 0.9


def dragon_ids(seed, n=128):
    """n sampled ids of chunk 37 of dragon 640x480 (4,096 samples)."""
    return torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
        np.arange(37 * 4096, 38 * 4096), n, replace=False)))


@pytest.fixture(scope="module")
def dragon_k3_cases():
    """Dragon's primary wave (coarse clustering) and bounce wave (fine,
    with its live mask) at 128 sampled ids x 4 paths, parity and clean,
    each with the plain version's answer: [(label, quirks, rec, features,
    live, t, index)]."""
    cases = []
    for mode, q in MODES.items():
        scene, waves = dragon_waves(q, dragon_ids(2), 4)
        o, d = waves["primary"]
        rec = scene.clusters.rec
        cases.append((f"{mode} primary", q, rec)
                     + plain_k3(o, d, rec, None, q))
        o1, d1, live = waves["bounce"]
        if mode == "parity":  # triangles shade black: no bounce ray lives
            assert not live.any()
            live = (torch.arange(live.shape[0]) % 3 > 0).float()
        rec = scene.clusters_fine.rec
        cases.append((f"{mode} bounce", q, rec)
                     + plain_k3(o1, d1, rec, live, q))
    return cases


@pytest.mark.parametrize("G", GROUPS)
def test_k3_lanes_match_plain_on_dragon_waves(libs, dragon_k3_cases, G):
    for label, q, rec, feats, live, pt, pi in dragon_k3_cases:
        t, i = lanes_k3(libs, feats, rec, live, G, q)
        assert torch.equal(t, pt) and torch.equal(i, pi), label
        assert (pt < culled.BIG).float().mean() > 0.05, label
        assert live is None or 0.1 < float(live.mean()) < 0.9, label


def duplicated_mesh(quirks):
    """A clustered mesh in which each cluster's first real record is copied
    into the next slot (another lane for every G > 1) with another
    original index: higher in even clusters, lower in odd ones. Returns
    (records, rays aimed at the copied triangles, the index pairs). Parity
    rays aim into the mirrored triangle its test accepts (u < 0)."""
    tris = synthetic_mesh(600, 3, "cpu")
    mesh = accel.build_clusters(*tris, cluster_size=accel.FINE_CLUSTER_SIZE)
    rec = mesh.rec.clone()
    C, cs = rec.shape[0], rec.shape[1]
    u = -1.0 if quirks.reference_triangle_test else 1.0
    pairs, targets = [], []
    for c in range(C):
        j = int((mesh.mask.reshape(C, cs)[c] > 0).nonzero()[0])
        orig = int(rec[c, j, 19])
        rec[c, j + 1] = rec[c, j]
        rec[c, j + c % 2, 19] = orig + 100000  # odd: the lower index later
        pairs.append((orig, orig + 100000))
        k = c * cs + j
        v0 = mesh.v0[k]
        targets.append(v0 + (u * (mesh.v1[k] - v0) + (mesh.v2[k] - v0)) / 3)
    targets = torch.stack(targets).repeat_interleave(8, 0)
    rng = np.random.default_rng(6)
    o = torch.from_numpy(rng.uniform(-14, 14, (targets.shape[0], 3))
                         .astype(np.float32))
    return rec, o, (targets - o).contiguous(), pairs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("G", GROUPS)
def test_k3_lanes_tie_goes_to_the_lower_index(libs, G, mode):
    rec, o, d, pairs = duplicated_mesh(MODES[mode])
    _, idx = assert_k3_lanes(libs, o, d, rec, None, G, MODES[mode])
    lower = {lo for lo, _ in pairs}
    higher = {hi for _, hi in pairs}
    idx = idx.tolist()
    assert sum(i in lower for i in idx) > 0.3 * len(idx)
    assert not any(i in higher for i in idx)


def t_clip_of(quirks):
    return 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS


def lanes_k4(libs, feats, bound, rec, live, G, quirks):
    """[R] bool of the host build's lane split: rec [C, cs, 20]."""
    n = feats.shape[0]
    rec = rec.contiguous()
    occ = torch.empty(n)
    libs[0].culled_occluded_host(
        n, rec.shape[0], rec.shape[1], G,
        1.0 if quirks.reference_triangle_test else -1.0, t_clip_of(quirks),
        feats.data_ptr(), bound.contiguous().data_ptr(),
        None if live is None else live.data_ptr(), rec.data_ptr(),
        occ.data_ptr())
    return occ > 0.5


def assert_k4_lanes(libs, feats, bound, rec, live, G, quirks):
    want = culled.culled_occluded_torch(
        feats, bound, rec, live,
        sign=1.0 if quirks.reference_triangle_test else -1.0,
        t_clip=t_clip_of(quirks))
    assert torch.equal(lanes_k4(libs, feats, bound, rec, live, G, quirks),
                       want)
    return want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("G", GROUPS)
def test_k4_lanes_match_plain_on_synthetic_mesh(libs, G, mode):
    tris = synthetic_mesh(1100, 9, "cpu")
    o, d, live, bound = random_rays(1500, 4, "cpu")
    feats = culled._ray_features10(o, d).contiguous()
    unbounded = torch.full_like(bound, culled.BIG)
    for cs in (accel.CLUSTER_SIZE, accel.FINE_CLUSTER_SIZE):
        mesh = accel.build_clusters(*tris, cluster_size=cs)
        for bnd in (unbounded, bound):
            for lv in (None, live):
                occ = assert_k4_lanes(libs, feats, bnd, mesh.rec, lv, G,
                                      MODES[mode])
                assert 0.05 < occ.float().mean() < 0.95


@pytest.fixture(scope="module")
def dragon_k4_cases():
    """Dragon's clean shadow waves toward its directional light, from the
    primary hits and from the bounce hits of 128 sampled ids x 4 paths of
    chunk 37, sorted as the wrapper sorts them (dead rays last), with the
    fine clustering the wrapper uses: [(label, features, live, rec)]."""
    scene, waves = dragon_waves(CLEAN, dragon_ids(4), 4)
    mesh = scene.clusters_fine
    cases = []
    for label in ("primary_shadow", "shadow"):
        o, d, live = waves[label]
        order, lv = culled._sort_rays(o, d, mesh, CLEAN, live)
        feats = culled._ray_features10(o, d)[order].contiguous()
        cases.append((label, feats, lv.contiguous(), mesh.rec))
    return cases


@pytest.mark.parametrize("G", GROUPS)
def test_k4_lanes_match_plain_on_dragon_shadow_waves(libs, dragon_k4_cases,
                                                     G):
    for label, feats, live, rec in dragon_k4_cases:
        n = feats.shape[0]
        assert 0.05 < float(live.mean()) < 0.95, label
        assert not live[int(live.sum()):].any(), label  # a dead tail
        for bnd in (torch.full((n,), culled.BIG),
                    torch.linspace(0.01, 0.3, n)):
            occ = assert_k4_lanes(libs, feats, bnd, rec, live, G, CLEAN)
            assert occ.any() and not occ[live == 0].any(), label


def moved_occluder_mesh(quirks):
    """A clustered mesh in which each cluster's first real triangle is moved
    to a later slot, a different one per cluster (so another lane than the
    first for every G > 1), its old slot zeroed (det = 0: never occludes);
    and rays aimed at the moved triangles from 5-15 units away. Returns
    (records, features, the distance to each target). Parity rays aim into
    the mirrored triangle its test accepts (u < 0)."""
    tris = synthetic_mesh(600, 3, "cpu")
    mesh = accel.build_clusters(*tris, cluster_size=accel.FINE_CLUSTER_SIZE)
    rec = mesh.rec.clone()
    C, cs = rec.shape[0], rec.shape[1]
    u = -1.0 if quirks.reference_triangle_test else 1.0
    rng = np.random.default_rng(8)
    targets = []
    for c in range(C):
        real = (mesh.mask.reshape(C, cs)[c] > 0).nonzero().flatten()
        j, k = int(real[0]), int(real[1 + c % (len(real) - 1)])
        rec[c, j], rec[c, k] = torch.zeros(accel.REC), rec[c, j].clone()
        v0 = mesh.v0[c * cs + j]
        targets.append(v0 + (u * (mesh.v1[c * cs + j] - v0)
                             + (mesh.v2[c * cs + j] - v0)) / 3)
    targets = torch.stack(targets).repeat_interleave(6, 0)
    d = torch.from_numpy(rng.normal(size=tuple(targets.shape)).astype(
        np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    dist = torch.from_numpy(rng.uniform(5, 15, targets.shape[0]).astype(
        np.float32))
    o = targets - d * dist[:, None]
    return rec, culled._ray_features10(o, d).contiguous(), dist


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("G", GROUPS)
def test_k4_lanes_find_an_occluder_in_another_lane(libs, G, mode):
    rec, feats, dist = moved_occluder_mesh(MODES[mode])
    # past the target: occluded by the moved triangle, whichever lane
    # holds it; short of it: only by what lies in front
    past = assert_k4_lanes(libs, feats, dist * 1.5, rec, None, G,
                           MODES[mode])
    short = assert_k4_lanes(libs, feats, dist * 0.5, rec, None, G,
                            MODES[mode])
    assert float(past.float().mean()) > 0.9
    assert float(short.float().mean()) < float(past.float().mean())


def lanes_k7(libs, feats, live, mesh, tables, G, shadows):
    shade, sph, lights, n_point, cnst = tables
    R, L = feats.shape[0], lights.shape[0]
    rec = mesh.rec.contiguous()
    out = [torch.empty(R, 3), torch.empty(R),
           torch.empty(R, dtype=torch.int32),
           torch.empty(R, dtype=torch.int32), torch.empty(R, L)]
    libs[1].fused_shade_host(
        R, rec.shape[0], rec.shape[1], G, shade.shape[0], sph.shape[0],
        n_point, L, int(shadows), feats.data_ptr(),
        None if live is None else live.data_ptr(), rec.data_ptr(),
        *(x.data_ptr() for x in (shade, sph, lights, cnst)),
        *(x.data_ptr() for x in out))
    return out


def plain_k7(o, d, scene, live):
    """(features, live as float, tables, the plain version's outputs
    without and with shadows)."""
    feats = culled._ray_features10(o, d).contiguous()
    lv = None if live is None else (live > 0).float().contiguous()
    tables = mk.pack_tables(scene)
    return feats, lv, tables, [
        mk.fused_shade_torch(feats, lv, scene.clusters.rec, *tables,
                             use_shadows=shadows) for shadows in (False, True)]


def assert_k7_lanes(libs, scene, G, feats, live, tables, plains):
    """The host lane split against the plain outputs, without and with
    shadows: t, kind, index and shadow bits equal, direct within 1e-6 of
    its largest value."""
    for shadows, plain in zip((False, True), plains):
        got = lanes_k7(libs, feats, live, scene.clusters, tables, G, shadows)
        for name, a, b in zip(("t", "kind", "index", "unsh"), got[1:],
                              plain[1:]):
            assert torch.equal(a, b), (name, shadows)
        err = (got[0] - plain[0]).abs().max().item()
        assert err <= 1e-6 * plain[0].abs().max().item()


@pytest.mark.parametrize("scene_fn", [make_mesh_scene, _dir_scene],
                         ids=["point_light", "directional"])
@pytest.mark.parametrize("G", GROUPS)
def test_k7_lanes_match_plain(libs, G, scene_fn):
    scene = scene_from_numpy(*scene_to_numpy(scene_fn()))
    o, d, live, _ = random_rays(900, 8, "cpu")
    for lv in (None, live):
        case = plain_k7(o * (10 / 12), d, scene, lv)
        assert_k7_lanes(libs, scene, G, *case)
        plain = case[3][1]
        hit = plain[2] > 0
        assert 0.1 < hit.float().mean() < 0.9
        assert 0.05 < plain[4][hit].mean() < 0.95


@pytest.fixture(scope="module")
def lit_dragon_k7_cases():
    """Lit dragon's primary and bounce waves (128 sampled ids x 2 paths of
    chunk 37) with the plain version's outputs."""
    scene, waves = dragon_waves(CLEAN, dragon_ids(3), 2,
                                scene=lit_dragon("cpu"))
    o1, d1, live = waves["bounce"]
    return scene, [plain_k7(*waves["primary"], scene, None),
                   plain_k7(o1, d1, scene, live)]


@pytest.mark.parametrize("G", GROUPS)
def test_k7_lanes_match_plain_on_lit_dragon(libs, lit_dragon_k7_cases, G):
    scene, cases = lit_dragon_k7_cases
    for case in cases:
        assert_k7_lanes(libs, scene, G, *case)
    primary = cases[0][3][1]
    hit = primary[2] > 0
    assert 0.2 < hit.float().mean() and 0.05 < primary[4][hit].mean() < 0.95


@pytest.mark.parametrize("n, C, cs, want", [
    (4096, 40, 256, (32, 8, 512, 4 * (2 * 256 * 20 + 7 * 40 + 1) + 12 * 40)),
    (65536, 79, 128, (16, 16, 4096, 4 * (2 * 128 * 20 + 7 * 79 + 1)
                      + 12 * 79)),
    (16384, 8, 256, (32, 8, 2048, 4 * (2 * 256 * 20 + 7 * 8 + 1) + 12 * 8)),
    (16385, 8, 256, (16, 16, 1025, 4 * (2 * 256 * 20 + 7 * 8 + 1) + 12 * 8)),
    (1, 3, 64, (32, 8, 1, 4 * (2 * 64 * 20 + 7 * 3 + 1) + 12 * 3)),
])
def test_launch_shape(n, C, cs, want):
    """Lanes from the wave's size, 256 / G rays per block, a ragged last
    block, and the ring, box table and shortlist in shared memory."""
    assert culled.launch_shape(n, C, cs) == want
    g, rays, blocks, smem = culled.launch_shape(n, C, cs, lanes=8)
    assert (g, rays, blocks) == (8, 32, -(-n // 32)) and smem == want[3]
    assert rays * g == culled.THREADS


def test_launch_shape_rejects_what_the_kernels_cannot_run():
    with pytest.raises(ValueError, match="lanes"):
        culled.launch_shape(4096, 40, 256, lanes=4)
    with pytest.raises(ValueError, match="shared memory"):
        culled.launch_shape(4096, 6000, 256)
    # K7's own tables count against the same limit
    C = 5000
    _, _, _, smem = culled.launch_shape(4096, C, 128)
    room = (culled.SMEM_LIMIT - smem) // 4
    culled.launch_shape(4096, C, 128, extra_floats=room)
    with pytest.raises(ValueError, match="shared memory"):
        culled.launch_shape(4096, C, 128, extra_floats=room + 1)

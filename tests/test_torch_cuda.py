"""The port's CUDA kernels on the card (marked `cuda`; skipped where no
GPU is visible — run them on the GPU machine with
`python -m pytest --noconftest -o addopts= tests/test_torch_cuda.py -q`:
the repo's conftest imports the JAX package, which the port does not need).

Each kernel against its plain PyTorch version on CUDA tensors, with the
launch counter: K1 with the kernel-vs-plain tolerance (0.5% of values
beyond 1e-4, frame means within 5e-4), its records bitwise; K2 within
1e-3 of each table's largest plain gradient plus 1e-5 and bitwise
reproducible, and gradients through both against the CPU plain path; the
mesh kernels K3, K4 and K5 with chip_smoke.py's (hits, occlusion and
indices equal on every ray, t within 1e-6 relative); K6 bitwise; K7 with
chip_smoke.py's `check_fused` (kind, index and shadow bits equal on every
ray, t within 1e-6 relative, direct within 1e-5 of its largest value,
live rays unchanged by the live mask and the ray order). K3, K4 and K7
also for every lane count per ray they are built for, at a wave size the
launcher gives 32 lanes and one it gives 16, with a ragged last block and
a dead tail (K3 and K4 bitwise, K7 as `fused_diff`), and K4 on waves whose
blocks are all dead; K2 at every lane count per sample it is measured at
and at the most lights it takes (within 1e-3 of each table's largest plain
gradient, two runs bitwise equal).
"""

import ctypes
import os

import pytest
import torch

from chip_smoke import (
    KERNEL_CASES,
    case_scene_and_config,
    check_fused,
    compare,
    fused_diff,
    fused_mesh_scene,
    nearest_diff,
    plain_culled_nearest,
    plain_occluded,
    plain_triangle_nearest,
    random_rays,
    synthetic_mesh,
)
from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu_torch.models.renderer import render
from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import culled
from skele_raytracer_tpu_torch.ops.cuda import intersect as k5
from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt
from skele_raytracer_tpu_torch.scene.parser import parse_scene

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_kernel_matches_plain_version(cuda, case):
    name, scene_name, overrides = case
    scene, cfg = case_scene_and_config(scene_name, overrides, 48, 32, cuda)
    ids = torch.arange(48 * 32 * cfg.samples_per_pixel, device=cuda)
    tabs = pt._pack_tables(scene)
    planes = pt._plane_inputs(cfg, ids)
    static = pt._static_kernel_args(scene, cfg)
    before = pt.LAUNCHES["pathtrace"]
    k = torch.stack(pt.pathtrace_forward(tabs, planes, 5, static), 1)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["pathtrace"] == before + 1
    ref = torch.stack(pt.frame_math_torch(tabs, planes, 5, **static), 1)
    frac, err, mean_diff, ok = compare(k, ref)
    assert ok, (name, frac, err, mean_diff)


@pytest.mark.parametrize("case", KERNEL_CASES[:5],
                         ids=[c[0] for c in KERNEL_CASES[:5]])
def test_records_and_backward_kernel_match_plain_versions(cuda, case):
    """K1's records bitwise; K2 within 1e-3 of each table's largest plain
    gradient plus 1e-5, and bitwise equal across two runs."""
    name, scene_name, overrides = case
    scene, cfg = case_scene_and_config(scene_name, overrides, 32, 24, cuda)
    n = 32 * 24 * cfg.samples_per_pixel
    tabs = pt._pack_tables(scene)
    planes = pt._plane_inputs(cfg, torch.arange(n, device=cuda))
    static = pt._static_kernel_args(scene, cfg)
    *rad, rec = pt.pathtrace_forward(tabs, planes, 5, static, records=True)
    *_, prec = pt.frame_math_torch(tabs, planes, 5, emit_records=True,
                                   **static)
    assert torch.equal(rec, prec), name
    fwd = pt.pathtrace_forward(tabs, planes, 5, static)
    assert all(torch.equal(a, b) for a, b in zip(rad, fwd))
    g = torch.randn(n, 3, device=cuda, generator=torch.Generator(
        cuda).manual_seed(0))
    before = pt.LAUNCHES["pathtrace_bwd"]
    k = pt.pathtrace_backward(tabs, planes, rec, g, 5, static)
    k2 = pt.pathtrace_backward(tabs, planes, rec, g, 5, static)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["pathtrace_bwd"] == before + 2
    plain = pt.replay_table_grads(tabs, planes, rec, g, 5, static)
    for a, b, w in zip(k, k2, plain):
        assert torch.equal(a, b)
        assert float((a - w).abs().max()) <= 1e-3 * float(
            w.abs().max()) + 1e-5


def test_gradients_through_the_kernels(cuda):
    """pathtrace_ids under autograd on the card: K1 with records, then K2;
    the scene leaves' gradients match the CPU plain path."""
    cfg = RenderConfig(width=8, height=6, monte_carlo=True, num_paths=2,
                       max_depth=2, use_shadows=True, backend="cuda")
    parsed = parse_scene(os.path.join(REPO, "scenes", "spheres1.scn"))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        scene = parsed.to_scene(cfg.quirks, device=dev)
        scene.spheres.center.requires_grad_(True)
        before = dict(pt.LAUNCHES)
        r = pt.pathtrace_ids(scene, cfg, 0, torch.arange(48, device=dev))
        (r * r).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert pt.LAUNCHES["pathtrace_records"] == (
                before["pathtrace_records"] + 1)
            assert pt.LAUNCHES["pathtrace_bwd"] == before["pathtrace_bwd"] + 1
        grads.append(scene.spheres.center.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_mesh_kernels_match_plain_versions(cuda, mode):
    quirks = PARITY if mode == "parity" else CLEAN
    o, d, live, bound = random_rays(20000, 4, cuda)
    mesh = accel.build_clusters(*synthetic_mesh(1100, 9, cuda),
                                cluster_size=accel.FINE_CLUSTER_SIZE)
    before = dict(culled.LAUNCHES)
    got = culled.triangle_nearest_culled(o, d, mesh, quirks=quirks, live=live)
    nearest_diff(got, plain_culled_nearest(o, d, mesh, quirks, live))
    occ = culled.triangle_occluded(o, d, mesh, quirks=quirks, t_max=bound,
                                   live=live)
    assert torch.equal(occ, plain_occluded(o, d, mesh, quirks, bound, live))
    torch.cuda.synchronize()
    assert culled.LAUNCHES["culled_nearest"] == before["culled_nearest"] + 1
    assert culled.LAUNCHES["culled_occluded"] == before["culled_occluded"] + 1
    tris = synthetic_mesh(700, 2, cuda)
    got = k5.triangle_nearest(o, d, *tris, quirks=quirks)
    want = plain_triangle_nearest(o, d, tris, quirks)
    nearest_diff(got[:3], want[:3])
    assert torch.equal(got[3][got[2]], want[3][want[2]])


WAVES = [4096 + 13, 20000 + 7]  # 32 and 16 lanes per ray; ragged tiles


def dead_tail(n, device):
    """A live mask whose last third is dead (sorted waves end so)."""
    return (torch.arange(n, device=device) < 2 * n // 3).float()


@pytest.mark.parametrize("n", WAVES)
def test_k3_lane_split_matches_plain_version(cuda, n):
    o, d, _, _ = random_rays(n, 5, cuda)
    feats = culled._ray_features10(o, d).contiguous()
    live = dead_tail(n, cuda)
    assert culled.lanes_for(n) == (32 if n < 16384 else 16)
    tris = synthetic_mesh(1100, 9, cuda)
    for cs in (accel.CLUSTER_SIZE, accel.FINE_CLUSTER_SIZE):
        mesh = accel.build_clusters(*tris, cluster_size=cs)
        for quirks in (PARITY, CLEAN):
            parity = quirks.reference_triangle_test
            want = culled.culled_nearest_torch(
                feats, mesh.rec, live, sign=1.0 if parity else -1.0,
                clip=not parity)
            assert 0.1 < (want[0] < culled.BIG).float().mean() < 0.9
            for lanes in (None, *culled.LANES):
                got = culled.culled_nearest_kernel(feats, mesh, live,
                                                   quirks=quirks, lanes=lanes)
                assert torch.equal(got[0], want[0]), (cs, lanes)
                assert torch.equal(got[1], want[1]), (cs, lanes)


@pytest.mark.parametrize("n", WAVES)
def test_k4_lane_split_matches_plain_version(cuda, n):
    o, d, _, bound = random_rays(n, 5, cuda)
    feats = culled._ray_features10(o, d).contiguous()
    live = dead_tail(n, cuda)
    tris = synthetic_mesh(1100, 9, cuda)
    for cs in (accel.CLUSTER_SIZE, accel.FINE_CLUSTER_SIZE):
        mesh = accel.build_clusters(*tris, cluster_size=cs)
        for quirks in (PARITY, CLEAN):
            parity = quirks.reference_triangle_test
            t_clip = 1.0 if quirks.near_clip_t_le_1 else 1e-4
            for bnd in (torch.full_like(bound, culled.BIG), bound):
                want = culled.culled_occluded_torch(
                    feats, bnd, mesh.rec, live, sign=1.0 if parity else -1.0,
                    t_clip=t_clip)
                assert 0.05 < want.float().mean() < 0.9
                for lanes in (None, *culled.LANES):
                    got = culled.culled_occluded_kernel(
                        feats, bnd, mesh, live, quirks=quirks, t_clip=t_clip,
                        lanes=lanes)
                    assert torch.equal(got, want), (cs, lanes)


def test_k4_dead_blocks_return_misses(cuda):
    """Blocks whose rays are all dead leave before they arm the ring: an
    all-dead wave, and one whose live rays fill only its first block, give
    the plain version's answer (and the kernel runs to its end)."""
    n = 20000
    o, d, _, bound = random_rays(n, 6, cuda)
    feats = culled._ray_features10(o, d).contiguous()
    mesh = accel.build_clusters(*synthetic_mesh(1100, 9, cuda),
                                cluster_size=accel.FINE_CLUSTER_SIZE)
    for live in (torch.zeros(n, device=cuda),
                 (torch.arange(n, device=cuda) < 5).float()):
        want = culled.culled_occluded_torch(feats, bound, mesh.rec, live,
                                            sign=-1.0, t_clip=1e-4)
        for lanes in (None, *culled.LANES):
            got = culled.culled_occluded_kernel(feats, bound, mesh, live,
                                                quirks=CLEAN, t_clip=1e-4,
                                                lanes=lanes)
            torch.cuda.synchronize()
            assert torch.equal(got, want), lanes
    assert not want[5:].any()


def test_backward_kernel_lanes_match_plain_version(cuda):
    """K2 at every lane count per sample it is measured at, on the fog and
    two-light case and on a case whose paths (2) are fewer than the lanes:
    within 1e-3 of each table's largest plain gradient plus 1e-5, two runs
    bitwise equal."""
    for name, scene_name, overrides in (KERNEL_CASES[1], KERNEL_CASES[2]):
        scene, cfg = case_scene_and_config(scene_name, overrides, 32, 24,
                                           cuda)
        n = 32 * 24 * cfg.samples_per_pixel - 5  # a ragged last stride
        tabs = pt._pack_tables(scene)
        planes = pt._plane_inputs(cfg, torch.arange(n, device=cuda))
        static = pt._static_kernel_args(scene, cfg)
        *_, rec = pt.pathtrace_forward(tabs, planes, 5, static, records=True)
        g = torch.randn(n, 3, device=cuda, generator=torch.Generator(
            cuda).manual_seed(0))
        plain = pt.replay_table_grads(tabs, planes, rec, g, 5, static)
        lib = pt.build_backward_kernel()
        assert lib.pathtrace_bwd_lanes_for(ctypes.byref(pt._params(
            n, 5, static))) == 1
        for lanes in (None, *pt.BWD_LANES, 32):
            k = pt.pathtrace_backward(tabs, planes, rec, g, 5, static,
                                      lanes=lanes)
            k2 = pt.pathtrace_backward(tabs, planes, rec, g, 5, static,
                                       lanes=lanes)
            for a, b, w in zip(k, k2, plain):
                assert torch.equal(a, b), (name, lanes)
                assert float((a - w).abs().max()) <= 1e-3 * float(
                    w.abs().max()) + 1e-5, (name, lanes)
    with pytest.raises(ValueError, match="lanes"):
        pt.pathtrace_backward(tabs, planes, rec, g, 5, static, lanes=3)


@pytest.mark.parametrize("case", KERNEL_CASES[-2:],
                         ids=[c[0] for c in KERNEL_CASES[-2:]])
def test_backward_kernel_at_most_lights(cuda, case):
    """K2 at the most lights the replay takes (22 with shadows, 32
    without: its per-thread light sums fill 140-176 KiB of shared memory at
    the largest tables): within 1e-3 of each table's largest plain gradient
    plus 1e-5, two runs bitwise equal."""
    name, scene_name, overrides = case
    scene, cfg = case_scene_and_config(scene_name, overrides, 32, 24, cuda)
    assert pt._can_replay(scene, cfg)
    n = 32 * 24 * cfg.samples_per_pixel
    tabs = pt._pack_tables(scene)
    planes = pt._plane_inputs(cfg, torch.arange(n, device=cuda))
    static = pt._static_kernel_args(scene, cfg)
    *_, rec = pt.pathtrace_forward(tabs, planes, 5, static, records=True)
    g = torch.randn(n, 3, device=cuda, generator=torch.Generator(
        cuda).manual_seed(0))
    plain = pt.replay_table_grads(tabs, planes, rec, g, 5, static)
    k = pt.pathtrace_backward(tabs, planes, rec, g, 5, static)
    k2 = pt.pathtrace_backward(tabs, planes, rec, g, 5, static)
    assert float(plain[3].abs().max()) > 0, name
    for a, b, w in zip(k, k2, plain):
        assert torch.equal(a, b), name
        assert float((a - w).abs().max()) <= 1e-3 * float(
            w.abs().max()) + 1e-5, name


@pytest.mark.parametrize("n", WAVES)
def test_k7_lane_split_matches_plain_version(cuda, n):
    scene = fused_mesh_scene()
    o, d, _, _ = random_rays(n, 17, cuda)
    feats = culled._ray_features10(o * (10 / 12), d).contiguous()
    live = dead_tail(n, cuda)
    tabs = mk.pack_tables(scene)
    for shadows in (True, False):
        want = mk.fused_shade_torch(feats, live, scene.clusters.rec, *tabs,
                                    use_shadows=shadows)
        for lanes in (None, *culled.LANES):
            got = mk.fused_shade_kernel(feats, live, scene.clusters, *tabs,
                                        use_shadows=shadows, lanes=lanes)
            fused_diff(f"shadows={shadows} lanes={lanes}", got, want)


def test_mesh_kernels_reject_cpu_and_bad_operands(cuda):
    mesh = accel.build_clusters(*synthetic_mesh(300, 1, cuda))
    o, d, _, _ = random_rays(64, 1, cuda)
    feats = culled._ray_features10(o, d)
    with pytest.raises(ValueError, match="CUDA"):
        culled.culled_nearest_kernel(feats.cpu(), mesh, None, quirks=CLEAN)
    with pytest.raises(ValueError, match="feats"):
        culled.culled_nearest_kernel(feats[:, :9].contiguous(), mesh, None,
                                     quirks=CLEAN)
    with pytest.raises(ValueError, match="CUDA"):
        k5.triangle_nearest_kernel(feats[:, :9].cpu(), mesh.rec[0].cpu(),
                                   sign=1.0, clip=False)


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_sphere_kernel_matches_plain_version(cuda, mode):
    quirks = PARITY if mode == "parity" else CLEAN
    o, d, _, _ = random_rays(20000, 6, cuda)
    c, r, m, _ = random_rays(300, 7, cuda)
    before = k5.LAUNCHES["sphere_nearest"]
    t, idx, hit = k5.sphere_nearest(o, d, c, r[:, 0].abs() + 0.3, m,
                                    quirks=quirks)
    torch.cuda.synchronize()
    assert k5.LAUNCHES["sphere_nearest"] == before + 1
    rows = k5.sphere_rows(c, r[:, 0].abs() + 0.3, m)
    pt_, pi = k5.sphere_nearest_torch(o, d, rows, 1.0 if mode == "parity"
                                      else 1e-4)
    assert torch.equal(hit, pt_ < k5.BIG) and torch.equal(idx, pi.long())
    assert torch.equal(t[hit], pt_[hit])
    assert 0.05 < hit.float().mean() < 0.95


def test_fused_kernel_matches_plain_version(cuda):
    o, d, _, _ = random_rays(20000, 17, cuda)
    before = mk.LAUNCHES["fused_shade"]
    check_fused("synthetic", (o * (10 / 12)).contiguous(), d,
                fused_mesh_scene())
    torch.cuda.synchronize()
    assert mk.LAUNCHES["fused_shade"] == before + 8  # 4 direct, 4 forwards


def test_fused_route_launches_only_k7(cuda):
    scene = fused_mesh_scene()
    cfg = RenderConfig(width=64, height=48, quirks=CLEAN, monte_carlo=True,
                       num_paths=4, max_depth=2, use_shadows=True,
                       backend="cuda", fused_megakernel=True)
    before = {m: dict(m.LAUNCHES) for m in (culled, k5, mk, pt)}
    img = render(scene, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())
    assert mk.LAUNCHES["fused_shade"] == before[mk]["fused_shade"] + 2
    for m in (culled, k5, pt):
        assert m.LAUNCHES == before[m]


def test_fused_kernel_rejects_cpu_and_bad_operands(cuda):
    scene = fused_mesh_scene()
    o, d, _, _ = random_rays(64, 1, cuda)
    feats = culled._ray_features10(o, d)
    tabs = mk.pack_tables(scene)
    with pytest.raises(ValueError, match="CUDA"):
        mk.fused_shade_kernel(feats.cpu(), None, scene.clusters, *tabs,
                              use_shadows=True)
    with pytest.raises(ValueError, match="feats"):
        mk.fused_shade_kernel(feats[:, :9].contiguous(), None,
                              scene.clusters, *tabs, use_shadows=True)
    with pytest.raises(ValueError, match="CUDA"):
        k5.sphere_nearest_kernel(o.cpu(), d.cpu(), tabs[1][:, :5].cpu(), 1.0)

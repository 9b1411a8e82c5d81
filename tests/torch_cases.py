"""Cases and checks shared by the port's tests and chip_smoke.py: scenes
and their render configurations, rays, meshes and a mesh scene's waves,
the plain versions of the mesh kernels' contracts, and the comparisons
that hold a kernel or a frame against its plain version.

Nothing here imports JAX or a test module: chip_smoke.py, which runs on
a machine without JAX, imports this file, and tests/test_torch_import.py
holds it to that.
"""

from __future__ import annotations

import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")

# tests/conftest.py TEST_SCN: four spheres, two decorative triangles, two
# point lights, a directional light, accumulated ambient.
TEST_SCN = """
camera -6 2 -4 .77 0 .64 0 1 0 35
background .05 .1 .15
material .6 .55 .5 .7 .6 .5 .3 .25 .2 32 .2 .2 .2 1.5
sphere 0 -50 0 50
material .2 .8 .9 .25 .9 1 .3 .3 .3 16 .2 .2 .2 1.3
sphere -3 1 0 .75
material 0 .7 0 0 .7 0 .1 .2 .1 8 .9 .9 .9 1.1
sphere 0 1.25 0 1
material .1 .1 .9 .2 .2 1 .4 .4 .4 24 0 0 0 1.0
sphere 3 1.5 0 1.25
vertex -15 -15 10
vertex -14 -15 10
vertex -13 -15 10
vertex -3 4 2
vertex 0 5 2
vertex -1.5 6.5 2
triangle 0 1 2
triangle 3 4 5
point_light 10 10 10 0 5 0
point_light 0 3 7 3 1 40
directional_light .8 .1 .1 -1 -1 1
ambient_light .15 .15 .15
ambient_light .1 .1 .1
max_depth 5
"""

# Kernel-vs-plain cases: (name, scene, RenderConfig overrides). Scenes:
# a path under scenes/, "test" (TEST_SCN) or "many128" (many_sphere_scene).
KERNEL_CASES = [
    ("spheres2_parity_gillum16", "spheres2.scn",
     dict(monte_carlo=True, num_paths=16, max_depth=2, use_shadows=True)),
    ("spheres2_clean_gillum4_fog", "spheres2.scn",
     dict(monte_carlo=True, num_paths=4, max_depth=2, use_shadows=True,
          mode="clean")),
    ("test_parity_gillum4", "test",
     dict(monte_carlo=True, num_paths=4, max_depth=2, use_shadows=True)),
    ("test_clean_gillum4", "test",
     dict(monte_carlo=True, num_paths=4, max_depth=2, use_shadows=True,
          mode="clean")),
    ("spheres1_clean_jsample2_depth3", "spheres1.scn",
     dict(grid_size=2, monte_carlo=True, num_paths=2, max_depth=3,
          use_shadows=True, mode="clean")),
    ("many128_parity_gillum2", "many128",
     dict(monte_carlo=True, num_paths=2, max_depth=2, use_shadows=True)),
    # the most lights the backward kernel takes, with shadows (the record
    # bits) and without (its shared memory, pathtrace.MAX_REPLAY_LIGHTS)
    ("lights22_clean_gillum4", "lights22",
     dict(monte_carlo=True, num_paths=4, max_depth=2, use_shadows=True,
          mode="clean")),
    ("lights32_clean_gillum4_no_shadows", "lights32",
     dict(monte_carlo=True, num_paths=4, max_depth=2, mode="clean")),
]

# Byte goldens of the reference binary: (file, scene, shadows, w, h, depth),
# parity, fov 60 (tests/test_golden.py REF_BINARY_CASES, sphere scenes).
BYTE_GOLDENS = [
    ("spheres1_bp.ppm.gz", "spheres1.scn", False, 640, 480, 1),
    ("spheres1_bp_shadows.ppm.gz", "spheres1.scn", True, 640, 480, 1),
    ("spheres2_bp.ppm.gz", "spheres2.scn", False, 640, 480, 1),
    ("spheres2_bp_shadows.ppm.gz", "spheres2.scn", True, 640, 480, 1),
    ("spheres1_serial_160.ppm.gz", "spheres1.scn", True, 160, 120, 3),
]

# `compare`'s kernel-vs-plain tolerance: at most FRAC_TOL of values off by
# more than ATOL, frame means within MEAN_TOL
FRAC_TOL, ATOL, MEAN_TOL = 0.005, 1e-4, 5e-4
T_RTOL = 1e-6  # mesh kernels vs plain: t within this relative error
CHUNK_RAYS = 1 << 16  # RenderConfig.rays_per_chunk: one wave's rays
FUSED_DIRECT_RTOL = 1e-5  # K7 vs plain: |direct diff| <= this x max|plain|

# The target's render seed. A fit renders step i with seed i; a target
# rendered with seed 0 would share step 0's samples, whose noise then
# cancels in the first loss only.
TARGET_SEED = 1000003


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def launched(mod, name, fn):
    """fn()'s result; checks that it launched `name` exactly once."""
    before = mod.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    check(mod.LAUNCHES[name] == before + 1, f"{name} was not launched")
    return out


def dev_us(event):
    """A profiler row's self device time in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_events(fn, warm):
    """The device-side rows of torch.profiler's key_averages for one
    `fn()`. The profiler's warm-up step runs `warm()` with tracing already
    started and its events dropped, so that the recorded step does not
    begin the trace: a trace can miss the launches at its very start."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in (warm, fn):
            step()
            torch.cuda.synchronize()
            prof.step()
    # device-side rows only (a CPU op's row repeats its kernels' time), and
    # not the step's own annotation, a device row that spans the whole step
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def many_sphere_scene(n=128, seed=3, device="cpu"):
    """tests/test_pathtrace.py's synthetic scene (the JAX kernel's
    loop-mode range), built from the same numpy draws."""
    from skele_raytracer_tpu_torch.scene.types import make_scene

    rng = np.random.default_rng(seed)
    spheres = []
    for _ in range(n):
        c = rng.uniform(-8, 8, 3)
        c[1] = abs(c[1])
        spheres.append(dict(
            center=tuple(c), radius=float(rng.uniform(0.3, 1.0)),
            ambient=tuple(rng.uniform(0, .3, 3)),
            diffuse=tuple(rng.uniform(0, 1, 3)),
            specular=tuple(rng.uniform(0, .5, 3)), transmissive=(0, 0, 0),
            power=float(rng.uniform(2, 40)), ior=1.2))
    return make_scene(
        spheres=spheres,
        point_lights=[dict(position=(0, 30, -20), colour=(500, 500, 500)),
                      dict(position=(-10, 10, 0), colour=(100, 80, 60))],
        ambient=(0.2, 0.2, 0.2), camera_position=(0, 3, -24),
        camera_direction=(0, 0, 1), camera_up=(0, 1, 0),
        background=(.05, .1, .15), device=device)


def lit_spheres2_text(lights):
    """spheres2.scn (2 point and 2 directional lights, a fog volume) with
    dim point lights added above it up to `lights` lights in all."""
    with open(os.path.join(SCENES, "spheres2.scn")) as f:
        text = f.read()
    return text + "".join(
        f"point_light 2 2 2 {3 * (i % 9) - 12} {6 + i % 4} {4 * (i // 9) - 8}\n"
        for i in range(lights - 4))


def case_scene_and_config(scene_name, overrides, width, height, device):
    """(port Scene, RenderConfig) of a KERNEL_CASES entry at a size."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
    from skele_raytracer_tpu_torch.scene.parser import (
        parse_scene,
        parse_scene_text,
    )

    kw = dict(overrides)
    quirks = CLEAN if kw.pop("mode", "parity") == "clean" else PARITY
    backend = "torch" if str(device) == "cpu" else "cuda"
    cfg = RenderConfig(width=width, height=height, quirks=quirks,
                       backend=backend, **kw)
    if scene_name == "many128":
        return many_sphere_scene(128, device=device), cfg
    if scene_name.startswith("lights"):
        parsed = parse_scene_text(lit_spheres2_text(int(scene_name[6:])))
        return parsed.to_scene(quirks, device=device), cfg
    parsed = (parse_scene_text(TEST_SCN) if scene_name == "test"
              else parse_scene(os.path.join(SCENES, scene_name)))
    return parsed.to_scene(quirks, device=device), cfg


def ulp_gap(a, b):
    """|a - b| of two float32 tensors in ulps, counted on the ordered
    integer line of their bits (so -0 and +0 are 0 apart)."""
    def line(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (line(a) - line(b)).abs()


def compare(a, b):
    """(frac_bad, max_abs_err, max mean diff) of two [N, 3] radiances, and
    whether they meet the kernel-vs-plain tolerance."""
    err = (a - b).abs()
    frac = (err > ATOL).float().mean().item()
    mean_diff = (a.mean(0) - b.mean(0)).abs().max().item()
    ok = frac <= FRAC_TOL and mean_diff <= MEAN_TOL and bool(
        torch.isfinite(a).all())
    return frac, err.max().item(), mean_diff, ok


def stochastic_bad_fraction(mu_ref, var_ref, n_ref, frames_q):
    """tests/test_golden.py's 3-sigma test: the fraction of channel values
    whose M-seed mean is outside 3 sigma (+1 LSB) of the reference's, and
    the aggregate bias of the means. frames_q: [M, ...] quantized frames."""
    M = frames_q.shape[0]
    mu_f = frames_q.astype(np.float64).mean(0)
    se = np.sqrt(var_ref * (1.0 / n_ref + 1.0 / M))
    bad = np.abs(mu_ref - mu_f) > 3.0 * se + 1.0
    return float(bad.mean()), float(abs(mu_ref.mean() - mu_f.mean()))


def headline(quirks, device="cuda", width=1920, height=1080):
    """(scene, cfg) of the 1080p spheres2 headline: gillum 16, depth 2,
    shadows (bench.py's fwd+bwd configuration)."""
    from skele_raytracer_tpu_torch.config import RenderConfig
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    cfg = RenderConfig(width=width, height=height, monte_carlo=True,
                       num_paths=16, max_depth=2, use_shadows=True,
                       quirks=quirks, backend="cuda" if device != "cpu"
                       else "torch")
    scene = parse_scene(os.path.join(SCENES, "spheres2.scn")).to_scene(
        quirks, device=device)
    return scene, cfg


def perturbed(scene):
    """examples/inverse_rendering.py's start: every sphere's diffuse 0.5,
    the point lights' colour x 0.3."""
    import dataclasses

    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(scene.spheres, diffuse=torch.full_like(
            scene.spheres.diffuse, 0.5)),
        point_lights=dataclasses.replace(
            scene.point_lights, colour=scene.point_lights.colour * 0.3))


def parsed_scene(name, quirks, device="cuda"):
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    return parse_scene(os.path.join(SCENES, name)).to_scene(quirks,
                                                             device=device)


def lit_dragon(device):
    """dragon.scn in clean mode with its directional light flipped. The
    file's light direction (1, -1, -1) points toward a light below the
    mesh: with shadows every surface the camera sees is occluded from it,
    so radiance has no gradient in the vertices. Flipped, the light comes
    from above."""
    import dataclasses

    from skele_raytracer_tpu_torch.config import CLEAN
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    scene = parse_scene(os.path.join(SCENES, "dragon.scn")).to_scene(
        CLEAN, device=device)
    dl = scene.directional_lights
    return dataclasses.replace(scene, directional_lights=dataclasses.replace(
        dl, direction=-dl.direction))


def synthetic_mesh(t, seed, device):
    """tests/test_accel.py's random mesh (v0, v1, v2, mask) on `device`:
    t triangles with unit-normal edges in [-8, 8]^3, the last 5 masked."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-8, 8, (t, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(t, 3)).astype(np.float32)
    v2 = v0 + rng.normal(size=(t, 3)).astype(np.float32)
    m = np.ones(t, np.float32)
    m[-5:] = 0.0
    return [torch.from_numpy(a).to(device) for a in (v0, v1, v2, m)]


def random_rays(n, seed, device):
    """n rays with origins in [-12, 12]^3 and normal directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    live = (rng.uniform(size=n) > 0.3).astype(np.float32)
    bound = rng.uniform(1, 20, n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (o, d, live, bound)]


def tied_k5_case(device, t=700, n=20000 + 7, seed=21):
    """K5's inputs (feats [n, 9], records [t, 20]) for its tie and miss
    rules: a synthetic mesh (`synthetic_mesh`) whose second half repeats
    its first (the same rows at indices 350 apart: exact-t ties between
    rows in different lanes and tiles; t not a multiple of the tile), and
    n rays of which the last third run on lines that pass the mesh by
    (all miss, also in parity, which accepts negative t)."""
    from skele_raytracer_tpu_torch.ops.cuda import intersect as k5

    half = synthetic_mesh(t // 2, seed, device)
    arrays = [torch.cat([a, a]) for a in half]
    o, d, _, _ = random_rays(n, seed + 1, device)
    k = n // 3
    o[-k:] = torch.tensor([100.0, 100.0, 100.0], device=device)
    d[-k:] = torch.tensor([1.0, 0.0, 0.0], device=device)
    return k5.ray_features(o, d).contiguous(), k5.pack_triangles(*arrays)


def k5_mesh_scene(t=700, seed=12, device="cpu"):
    """A scene whose mesh (t triangles, at most 4 clusters of 256) takes
    the brute-force kernel K5, with a ground sphere and a point light
    (tests/test_torch_wavefront.py's)."""
    from skele_raytracer_tpu_torch.scene.types import make_scene

    rng = np.random.default_rng(seed)
    mat = dict(ambient=(0.1, 0.1, 0.1), diffuse=(0.6, 0.5, 0.4),
               specular=(0.2, 0.2, 0.2), transmissive=(0, 0, 0), power=8.0,
               ior=1.0)
    tris = []
    for _ in range(t):
        v0 = rng.uniform(-6, 6, 3)
        tris.append(dict(v0=tuple(v0), v1=tuple(v0 + rng.normal(size=3)),
                         v2=tuple(v0 + rng.normal(size=3)), **mat))
    return make_scene(
        triangles=tris,
        spheres=[dict(center=(0, -60, 0), radius=50.0, **mat)],
        point_lights=[dict(position=(0, 20, -10), colour=(200, 200, 200))],
        ambient=(0.2, 0.2, 0.2), camera_position=(0, 0, -14),
        camera_direction=(0, 0, 1), camera_up=(0, 1, 0),
        background=(0.05, 0.1, 0.15), device=device)


def fused_mesh_scene(t=700, seed=12, device="cuda"):
    """tests/conftest.py make_mesh_scene's scene, from the same draws
    (without conftest, which imports JAX): k5_mesh_scene's triangles,
    sphere and point light, clustered 64 triangles at a time so that the
    mesh has more than 4 clusters and takes the fused route."""
    import dataclasses

    from skele_raytracer_tpu_torch.ops import accel

    scene = k5_mesh_scene(t, seed, device)
    tr = scene.triangles
    return dataclasses.replace(scene, clusters=accel.build_clusters(
        tr.v0, tr.v1, tr.v2, tr.mask, cluster_size=64))


def mesh_waves(scene, quirks, width, height, ids, paths):
    """A mesh scene's waves at width x height for the sample ids, on their
    device (the card's kernels, or the plain versions on the CPU): the
    primary rays, the bounce rays of `paths` Monte-Carlo paths per sample
    with their live mask (the integrator's), and, where the scene has a
    directional light, the shadow rays toward it from the bounce hits
    (clean keeps the light) with theirs, and the shadow rays toward it from
    the primary hits (`primary_shadow`)."""
    from skele_raytracer_tpu_torch.config import RenderConfig
    from skele_raytracer_tpu_torch.models import integrator
    from skele_raytracer_tpu_torch.ops.camera import rays_for_ids
    from skele_raytracer_tpu_torch.ops.geometry import (
        intersect,
        normalize,
        offset_origin,
    )
    from skele_raytracer_tpu_torch.ops.shading import gather_material

    cfg = RenderConfig(width=width, height=height, quirks=quirks,
                       monte_carlo=True, num_paths=paths, max_depth=2,
                       backend="cuda" if ids.is_cuda else "torch")
    o, d = rays_for_ids(scene.camera, cfg, 0, ids)
    o = o.contiguous()
    hits = intersect(o, d, scene, quirks=quirks)
    mat = gather_material(scene, hits.kind, hits.index, quirks=quirks)
    rep = lambda x: torch.repeat_interleave(x, paths, dim=0)
    path_ids = (ids[:, None] * paths
                + torch.arange(paths, device=ids.device)[None, :]).reshape(-1)
    hits_p = type(hits)(*(rep(x) for x in hits))
    mat_p = type(mat)(*(rep(x) for x in mat))
    o1, d1, f = integrator._mc_continue(scene, cfg, 0, hits_p, mat_p,
                                        path_ids, 0)
    shades = (hits_p.kind == 1) | ((hits_p.kind == 2)
                                   & (not quirks.triangles_shade_black))
    live = ((f * shades[:, None]) != 0).any(dim=1).float()
    waves = dict(primary=(o, d), bounce=(o1, d1, live))
    if scene.has_directional:
        to_l = normalize(scene.directional_lights.direction[0])
        h1 = intersect(o1, d1, scene, quirks=quirks, live=live)
        org = offset_origin(h1.point, h1.normal)
        waves["shadow"] = (org, to_l.expand_as(org).contiguous(),
                           live * (h1.kind > 0).float())
        org0 = offset_origin(hits.point, hits.normal)
        waves["primary_shadow"] = (org0, to_l.expand_as(org0).contiguous(),
                                   (hits.kind > 0).float())
    return waves


def dragon_waves(quirks, ids, paths, scene=None):
    """Dragon's waves at 640x480 (of `scene`, by default dragon.scn on the
    ids' device) for the sample ids (`mesh_waves`)."""
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    if scene is None:
        scene = parse_scene(os.path.join(SCENES, "dragon.scn")).to_scene(
            quirks, device=ids.device)
    return scene, mesh_waves(scene, quirks, 640, 480, ids, paths)


def eager_frame(scene, cfg, seed):
    """The frame `render` gives, through `render_ids` chunk by chunk with
    no CUDA graph: the wavefront's eager path."""
    from skele_raytracer_tpu_torch.models.renderer import (
        _chunk_samples,
        render_ids,
    )

    cfg = cfg.resolved()
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    ids = torch.arange(H * W * spp, dtype=torch.int64, device=cfg.device)
    chunk = _chunk_samples(cfg)
    with torch.no_grad():
        rad = torch.cat([render_ids(scene, cfg, seed, ids[i:i + chunk])
                         for i in range(0, ids.shape[0], chunk)])
    return rad.reshape(H, W, spp, 3).mean(dim=2)


def k6_shape(shape, device="cuda"):
    """(o, d, spheres) of K6's two timed shapes on spheres2 (parity):
    "chunk", 65,536 primary rays of the 1920x1080 frame from row 540 on;
    "frame", the whole frame's 2,073,600 primary rays."""
    from skele_raytracer_tpu_torch.config import PARITY, RenderConfig
    from skele_raytracer_tpu_torch.ops.camera import rays_for_ids

    scene = parsed_scene("spheres2.scn", PARITY, device)
    cfg = RenderConfig(width=1920, height=1080)
    ids = (torch.arange(540 * 1920, 540 * 1920 + CHUNK_RAYS, device=device)
           if shape == "chunk" else
           torch.arange(1920 * 1080, device=device))
    o, d = rays_for_ids(scene.camera, cfg, 0, ids)
    return o.contiguous(), d.contiguous(), scene.spheres


def nearest_diff(kernel, plain):
    """Checks a nearest-hit kernel's (t, index, hit) against its plain
    version's: hit flags and indices equal on every ray, t within T_RTOL
    relative where hit. Returns (max |t diff| over hits, hit share)."""
    kt, ki, kh = kernel
    pt, pi, ph = plain
    check(torch.equal(kh, ph), f"hit flags differ on {(kh != ph).sum()} rays")
    check(torch.equal(ki[kh], pi[ph]),
          f"indices differ on {(ki[kh] != pi[ph]).sum()} rays")
    if not bool(kh.any()):
        return 0.0, 0.0
    err = (kt[kh] - pt[kh]).abs()
    check(bool((err <= T_RTOL * pt[kh].abs()).all()),
          f"t differs by up to {err.max().item():.3e}")
    return err.max().item(), kh.float().mean().item()


def plain_culled_nearest(o, d, mesh, quirks, live=None):
    """K3's contract through its plain version, brute force and in the
    rays' own order: (t (inf = miss), index, hit)."""
    from skele_raytracer_tpu_torch.ops.cuda import culled

    lv = None if live is None else (live > 0).float()
    t, idx = culled.culled_nearest_torch(
        culled._ray_features10(o, d), mesh.rec, lv,
        sign=1.0 if quirks.reference_triangle_test else -1.0,
        clip=not quirks.reference_triangle_test)
    hit = t < culled.BIG
    idx = torch.clamp(idx.long(), max=mesh.perm.shape[0] - 1)
    return torch.where(hit, t, float("inf")), idx, hit


def plain_occluded(o, d, mesh, quirks, t_max=None, live=None):
    """K4's contract through its plain version: [R] bool."""
    from skele_raytracer_tpu_torch.config import CLEAN_T_EPS
    from skele_raytracer_tpu_torch.ops.cuda import culled

    bound = (torch.full((o.shape[0],), culled.BIG, device=o.device)
             if t_max is None else t_max)
    return culled.culled_occluded_torch(
        culled._ray_features10(o, d), bound, mesh.rec,
        None if live is None else (live > 0).float(),
        sign=1.0 if quirks.reference_triangle_test else -1.0,
        t_clip=1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS)


def plain_triangle_nearest(o, d, tris, quirks):
    """K5's contract through its plain version: (t, index, hit, u, v)."""
    from skele_raytracer_tpu_torch.ops.cuda import intersect as k5

    t, idx, u, v = k5.triangle_nearest_torch(
        k5.ray_features(o, d), k5.pack_triangles(*tris),
        sign=1.0 if quirks.reference_triangle_test else -1.0,
        clip=not quirks.reference_triangle_test)
    hit = t < k5.BIG
    idx = torch.clamp(idx.long(), max=tris[0].shape[0] - 1)
    return torch.where(hit, t, float("inf")), idx, hit, u, v


def fused_diff(label, k, p):
    """Checks K7's outputs `k` against its plain version's `p`: kind,
    index and the shadow bits equal on every ray, t bitwise on misses and
    within T_RTOL relative on hits, direct within FUSED_DIRECT_RTOL of the
    plain version's largest value. Returns (max |direct diff|, max |t diff|
    over hits, max |direct|)."""
    for a, b, what in zip(k[2:], p[2:], ("kind", "index", "unsh")):
        check(torch.equal(a, b), f"K7 {label}: {what} differs on "
              f"{(a != b).sum().item()} values")
    hit = p[2] > 0
    t_err = (k[1] - p[1]).abs()
    check(torch.equal(k[1][~hit], p[1][~hit]) and bool(
        (t_err[hit] <= T_RTOL * p[1][hit].abs()).all()),
        f"K7 {label}: t differs by up to {t_err.max().item():.3e}")
    d_err = (k[0] - p[0]).abs().max().item()
    scale = p[0].abs().max().item()
    check(d_err <= FUSED_DIRECT_RTOL * scale,
          f"K7 {label}: direct off by {d_err:.3e} (max {scale:.3e})")
    return d_err, t_err[hit].max().item() if bool(hit.any()) else 0.0, scale


def check_fused(label, o, d, scene, live=None):
    """K7 against its plain version on the card on one wave, with and
    without shadows, with the wave's live mask (or none) and with one that
    covers half the rays: kind, index and the shadow bits equal on every
    ray, t bitwise or within T_RTOL relative, direct within
    FUSED_DIRECT_RTOL of the plain version's largest value. Then a live
    ray's outputs through `fused_shade_forward` must not change with the
    live mask or the ray order. Returns (worst |direct diff|, worst |t
    diff|)."""
    from skele_raytracer_tpu_torch.ops.cuda import culled
    from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk

    mesh = scene.clusters
    half = (torch.from_numpy(np.random.default_rng(o.shape[0]).uniform(
        size=o.shape[0]) < 0.5).float().cuda())
    tabs = mk.pack_tables(scene)
    worst_direct, worst_t = 0.0, 0.0
    for shadows in (True, False):
        for name, lv in (("own mask" if live is not None else "no mask",
                          live), ("half live", half)):
            order, lvs = mk.sort_rays(o, d, mesh, lv)
            feats = culled._ray_features10(o, d)[order].contiguous()
            k = launched(mk, "fused_shade", lambda: mk.fused_shade_kernel(
                feats, lvs, mesh, *tabs, use_shadows=shadows))
            p = mk.fused_shade_torch(feats, lvs, mesh.rec, *tabs,
                                     use_shadows=shadows)
            d_err, t_worst, scale = fused_diff(label, k, p)
            hit = p[2] > 0
            lit = p[4][hit].mean().item() if bool(hit.any()) else 1.0
            worst_direct = max(worst_direct, d_err)
            worst_t = max(worst_t, t_worst)
            n_live = o.shape[0] if lvs is None else int(lvs.sum())
            print(f"[fused] K7 {label} shadows={shadows} {name}: "
                  f"{o.shape[0]} rays, {n_live} live, "
                  f"{hit.float().sum().item() / max(n_live, 1):.3f} of live "
                  f"hit, shadow bits {lit:.3f} unshadowed; kind, index, "
                  f"shadow bits equal, max |t diff| {t_worst:.3e}, max "
                  f"|direct diff| {d_err:.3e} (max {scale:.3e}) (ok)")
        a = mk.fused_shade_forward(o, d, scene, use_shadows=shadows,
                                   live=live)
        b = mk.fused_shade_forward(o, d, scene, use_shadows=shadows,
                                   live=half if live is None else live * half,
                                   reorder=False)
        keep = (half > 0) if live is None else (live * half) > 0
        check(all(torch.equal(x[keep], y[keep]) for x, y in zip(a, b)),
              f"K7 {label}: live rays changed with the mask or the order")
    return worst_direct, worst_t


def k6_one_launch(label, call):
    """Checks that one `call()` of K6's entry is one launch of
    sphere_nearest_kernel and no other device work, in a profiler trace
    (retaken when it holds no row: a trace can lose a launch)."""
    from skele_raytracer_tpu_torch.ops.cuda import intersect as ik

    launched(ik, "sphere_nearest", call)
    for _ in range(3):
        rows = device_events(call, call)
        if rows:
            break
    names = "; ".join(f"{e.key[:70]} x{e.count}" for e in rows)
    check(len(rows) == 1 and rows[0].count == 1
          and "sphere_nearest_kernel<" in rows[0].key,
          f"K6 {label}: one call's trace holds {names or 'nothing'}, want "
          f"one sphere_nearest_kernel")
    print(f"[fused] K6 {label}: one sphere_nearest call = 1 launch, and its "
          f"profiler trace holds that kernel alone ({names}) (ok)")

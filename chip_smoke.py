"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the CLI, `render` and `train.fit`,
through the hand-written CUDA kernels, after checking every kernel against
its plain PyTorch version and the reference goldens:

* the whole-frame path tracer K1 (sphere scenes): spheres2.scn, 1920x1080,
  parity, --gillum 16 --depth 2 --shadow;
* the chunked wavefront with the mesh kernels K3 (culled nearest hit), K4
  (culled any hit) and K5 (brute-force nearest hit): dragon.scn at
  640x480, clean --gillum 16 --depth 2 --shadow and parity --depth 2
  --shadow, and a synthetic 700-triangle mesh for K5;
* training: `train.fit` at the same 1080p spheres2 headline, parity and
  clean, each step K1 with hit records and the backward kernel K2; and a
  mesh gradient through K3/K4 (dragon, triangle vertices trainable);
* the fused route (`RenderConfig.fused_megakernel`): dragon.scn at
  640x480 and test.scn at 1024x768, clean, depth 2, shadows, through the
  fused kernel K7, with its gradient and a fit; and the nearest-sphere
  kernel K6, which no render path launches;
* the clean Whitted integrator (reflection, refraction, Fresnel): test.scn
  at 1024x768 through the CLI (K3 and K4) and both routes (K7 fused),
  spheres2 at 1920x1080 (no kernel), lit dragon at 640x480, depth 3,
  shadows; progressive rendering with a resume, `--profile` and the
  debug checks;
* rays sharded over devices and processes (parallel/): the 1080p
  headline's frame and training step over 4 shards of the card and in a
  2-rank gloo group on it; the inverse-rendering example at its defaults;
* the kernel lab (ops/cuda/lab.py, skele_raytracer_tpu_torch/tools/): the
  Plucker-product nearest-hit kernels L1-L6 on dragon's 131,072-ray
  bounce batch, which no render path launches; the batch on a recursive
  object-median clustering (tools/lab_median.py); and the fixed-topology
  finite-difference check of K2's gradient (tools/fixed_topology_fd.py).

Phases, in order; any failure raises and exits nonzero:

1. device: nvidia-smi's name and power limit, torch and CUDA versions;
   no GPU -> exit 1 before anything else.
2. build: nvcc builds every kernel library from
   skele_raytracer_tpu_torch/csrc/, one nvcc per library, all at once
   (with the measurement builds of K4's lanes and K1's variants);
   `[sass]`: the scan loops of K1 and K5 in the built code (cuobjdump),
   and the tensor-core instructions (HMMA) of the lab's L1, L2, L5 and L6
   at passes 3, which every such instance must hold, with the registers
   and spills of every L3 and L5 instance (the split walk), L6 and L1 at
   G 4 side by side.
3. kernel vs plain on the card: K1 on each of KERNEL_CASES (at most 0.5%
   of values off by more than 1e-4, frame means within 5e-4: the
   tolerance of tests/test_pathtrace.py), its records bitwise, and K2
   against autograd of the plain replay on the same cases and on 65,536
   ids of the 1080p headline, parity and clean (per table |k2 - plain| <=
   1e-3 max|plain| + 1e-5, tests/test_pathtrace.py's tolerance; two runs
   bitwise equal; two of the cases hold the most lights K2 takes, 22 with
   shadows and 32 without); K3, K4 and K5 on synthetic
   meshes (parity and clean, with t_max and live) and on dragon's primary
   and bounce waves (coarse and fine clusterings): hit flags, occlusion
   and indices equal on every ray, t within 1e-6 relative; K5 at every
   lane count per ray it is built for, bitwise (t, index, u, v), on a
   mesh with exact-t ties and all-miss rays. Each case must launch its
   kernel.
   K3, K4 and K7 for each lane count per ray they are built for, at
   dragon's 4,096-ray primary wave and at a bounce wave of 65,536 - 37
   rays with a dead tail, K4 at the shadow waves from both, unbounded and
   bounded (K3, K4 bitwise; K7 as below); K2 for each lane count per
   sample of pathtrace.BWD_LANES at the 65,536 headline ids.
   [fused] K6 bitwise against its plain version (65,536 random rays x 24
   spheres, parity and clean clip; test.scn's spheres) and its time at
   spheres2's table; K7 against its plain version on five waves (a
   synthetic 700-triangle mesh with a sphere and a point light, lit
   dragon's primary and bounce waves, test.scn's primary and bounce
   waves), with and without shadows, with and without a live mask: kind,
   index and shadow bits equal, t within T_RTOL, direct within
   FUSED_DIRECT_RTOL of its largest value, live rays unchanged by the mask
   and the ray order. Then the fused main path: `render` of dragon 640x480
   clean gillum 16 (150 K7 launches, no other kernel) and of test.scn
   1024x768 clean gillum 4, each against the split route (>= 99% of
   values within 1e-3) and timed beside it, a device profile of both
   dragon frames, lit dragon against split and against the CPU plain path
   on sampled ids, K7 alone at both waves of dragon's chunk 37; the fused
   gradient (lit dragon 160x120, 256 ids) against the CPU and against
   split; a 3-step fit through K7.
4. goldens: whole frames against the reference binary's goldens (>= 99.5%
   byte-identical pixels; spheres through K1, dragon and test.scn through
   the wavefront) and the 3-sigma stochastic test.
5. main paths, each with the launch counters set to 0 just before and read
   just after: the 1080p K1 CLI run; the dragon clean CLI run, which must
   launch K3 and K4; the dragon parity CLI run, which must launch K3 and
   not K4; a synthetic-mesh `render`, which must launch K5. Then `render`
   against the plain path (the same code on the CPU) on sampled ids; K1
   at both 1080p headlines with its records variant and its bounds,
   `[tune]` lines over the measurement build's variants (each bitwise
   equal to the kernel) and the share of bounce records that miss; and
   timings with CUDA events over warm runs: each kernel alone and its
   plain version at one main-path chunk's shape (K3 and K7 at both waves
   of dragon's chunk 37, K4 at its two shadow waves, K5 at a 65,536-ray
   chunk, by profiler device time, each lane count too: `[tune]`), and
   `render` end to end. `[lab]` (`phase_lab`, ~25 s): every row of the
   kernel lab's three harnesses (skele_raytracer_tpu_torch/tools/
   kernel_lab.py, lab_v5.py, lab_probe.py) on dragon's bounce batch,
   each kernel against its plain version (full FP32 bitwise; bf16x3 hit
   flags on >= 99.9% of rays, indices equal where t agrees to 1e-4) and
   against K3 (the full-FP32 walks bitwise), timed beside its bound (device
   ms per call: the sum of its kernels, three for L3's and L5's split
   walk, whose rows also print their work items and the same kernel at
   one item per tile, bitwise equal on every ray, and the time one block
   per tile took at commit 7caea27; L5 also against L3 at one block per
   SM); L5's and L6's rows bitwise their L3 twins on the live rays; and
   the cs-sweep. `[median]` (`phase_median`): the lab batch on Morton runs and
   on the recursive object median, each one's shortlists and K3's time,
   K3's answers bitwise equal after the unsort. `[fd]` (`phase_fd`): the
   fixed-topology check at bench.py's 96x54 spheres1 frame, K1's records
   and K2's gradient against float64 central differences of the replay on
   the card (figure <= 1e-3), and the plain backward's figure.
6. training, each run with the launch counters set to 0 just before and
   read just after: `train.fit` for 3 steps at the 1080p headline (parity
   and clean; finite, decreasing losses, one K1-with-records and one K2
   launch per step) with its timings, K2 at each lane count (`[tune]`)
   and a profiled `train_step`; K2 timed at 22 and 32 lights over a
   1080p frame (`phase_k2_lights`); a 64x36 fit on the card against the
   same fit on the CPU (losses within 1e-4 relative); the 128-sphere
   scene's gradient, which takes the wavefront route; a dragon gradient
   through K3/K4 against the CPU plain path (vertex gradients within 1e-3
   of their largest plus 1e-5, nonzero) and one fit step that refreshes
   the clusters and the normal table.
7. [whitted] the clean Whitted integrator, depth 3, shadows, each run
   with the launch counters set to 0 just before and read just after:
   `python -m skele_raytracer_tpu_torch --path scenes/test.scn --mode
   clean --shadow --depth 3` at the file's 1024x768 (K3 and K4, neither
   K1 nor K7; a valid P6); the same frame through `render` on the split
   route against the CPU on sampled ids (`compare`) and on the fused
   route (only K7; >= 99% of values within 1e-3 of the split frame),
   each timed (median of 3 warm frames) with its launches per frame, a
   device profile of one chunk (idle share) and the live share of each
   of that chunk's waves; spheres2 at 1920x1080 (glass spheres: refraction
   and total internal reflection; no kernel), against the CPU and timed;
   lit dragon at 640x480, split and fused as test.scn; a Whitted
   gradient of lit dragon's vertices (160x120, depth 2, 256 ids) through
   K3/K4 against the CPU (within 1e-3 of their largest plus 1e-5,
   nonzero).
8. [surface] the 1080p spheres2 parity headline through the CLI in 64-row
   bands with --resume and --preview-dir, killed after 4 bands
   (SKT_FAULT_AFTER_BANDS, a subprocess that must exit nonzero and leave
   its state and preview.ppm), then resumed (one K1 launch per remaining
   band), byte-equal to a one-shot render; the bands' wall time beside
   one-shot `render`; `--profile DIR` on a test.scn Whitted run (256x192,
   a subprocess), whose trace must name K3's and K4's kernels; `debug.checked_render` of
   test.scn 64x48 clean Whitted on the card.
9. [parallel] (the card is the only one: NCCL and multi-GPU scaling are
   not measured here), each run with the launch counters set to 0 just
   before and read just after: the 1080p parity headline through
   `render_radiance_sharded` on a 4-shard mesh of cuda:0 (4 K1 launches,
   bitwise equal to one-shot `render`), timed in turns with one-shot; a
   sharded `train_step` (4 K1-with-records and 4 K2 launches; loss within
   1e-6 relative and each gradient within 1e-5 + 1e-3 |ref| of the
   single-device step's); a 2-rank gloo group spawned on the card (a
   process each, both on cuda:0): the frame gathered on rank 0 bitwise
   equal to one-shot, one step's loss (1e-6 relative) and updated leaves
   (1e-6 absolute) against the single-process step, the all-reduce's
   time; `multihost.scaling_report` at 1, 2 and 4 shards of the card,
   which is the overhead of sharding, not scaling.
10. [example] examples/inverse_rendering_torch.py at its defaults (a
   process of its own): its PPMs, falling losses, its MAE.
11. [roofline] `utils/roofline.analyze_trace` of phase 8's --profile
   trace and `sol_summary` of K1's counted work at the 1080p headline.
12. a JSON line of the kernels (with each one's bound from counted
   operations and bytes: utils/roofline.py; the lab's L1-L6 with 0
   launches on the render paths), nvidia-smi's line, and the final line
   {"ok": true, "device": {...}}.

With `--parent-csrc DIR` (an earlier commit's skele_raytracer_tpu_torch/
csrc, e.g. `git archive` of it unpacked under build/), that tree's K1, K5,
K7 and K3/K4 are built too, held bitwise against this tree's (K1's r, g, b
and records at both 1080p headlines, K5's t, index, u, v at its chunk,
K7's outputs at dragon's chunk 37, the fused and split dragon frames) and
timed in turns with them on the same inputs; `render` and a `train_step`
at the 1080p headlines run through each tree's K1 in turns, and the fused
and split dragon frames through each tree's kernels; `[sass]` compares the
kernel lab's tile-walk instances (L1, L2, L4, L6) with that tree's
culled_lab.cu, function by function (`lab_sass_against`).

Nothing here imports JAX. Scratch files go under build/smoke/.
"""

from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the kernels' bounds: counted operations at the H100's peaks and bytes at
# HBM's rate
from skele_raytracer_tpu_torch.utils.roofline import (
    fused_work,
    k1_model,
    k1_work,
    k2_work,
    k5_work,
    k6_work,
    mesh_work,
    occluded_work,
)

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(REPO, "scenes")
GOLDENS = os.path.join(REPO, "tests", "goldens")
SCRATCH = os.path.join(REPO, "build", "smoke")

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

# The reference binary's mesh goldens (tests/test_golden.py), parity:
# dragon (10,002 triangles, the culled kernel K3) and test.scn (1,800).
MESH_GOLDENS = [
    ("dragon_bp_shadows.ppm.gz", "dragon.scn", True, 640, 480, 1),
    ("test_bp_shadows.ppm.gz", "test.scn", True, 640, 480, 1),
]

FRAC_TOL, ATOL, MEAN_TOL = 0.005, 1e-4, 5e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5  # K2 vs plain, per table (x max|plain|)

MIN_EXACT = 0.995
T_RTOL = 1e-6  # mesh kernels vs plain: t within this relative error
CHUNK_RAYS = 1 << 16  # RenderConfig.rays_per_chunk: one wave's rays
PROFILE_TRIES = 3  # traces of one step before its breakdown is "not measured"


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


def read_golden_ppm(name):
    from skele_raytracer_tpu_torch.utils.image import parse_ppm

    with open(os.path.join(GOLDENS, name), "rb") as f:
        return parse_ppm(gzip.decompress(f.read()))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def timed(fn):
    """(fn()'s result, its milliseconds on the card by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def cuda_ms(fn, reps):
    """Per-call milliseconds of `fn` on the card: CUDA events around each
    of `reps` calls; returns the list."""
    return [timed(fn)[1] for _ in range(reps)]


def kernel_modules():
    from skele_raytracer_tpu_torch.ops.cuda import culled
    from skele_raytracer_tpu_torch.ops.cuda import intersect as k5
    from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    return pt, culled, k5, mk


def counted_modules():
    """The modules whose kernels count their launches: the render paths'
    and the kernel lab's (ops/cuda/lab.py, on no render path)."""
    from skele_raytracer_tpu_torch.ops.cuda import lab

    return (*kernel_modules(), lab)


def reset_launches():
    for mod in counted_modules():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def read_launches() -> dict:
    out = {}
    for mod in counted_modules():
        out.update(mod.LAUNCHES)
    return out


def launched(mod, name, fn):
    """fn()'s result; checks that it launched `name` exactly once."""
    before = mod.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    check(mod.LAUNCHES[name] == before + 1, f"{name} was not launched")
    return out


def median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn, reps))


def turns_ms(fns, reps=10):
    """Median milliseconds of each of `fns` on the card, timed in turns
    (forward, then backward through the list, `reps` rounds; CUDA events
    around each call) after one warm-up call each."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    samples = [[] for _ in fns]
    for rnd in range(reps):
        order = range(len(fns)) if rnd % 2 == 0 else reversed(range(len(fns)))
        for k in order:
            samples[k].append(timed(fns[k])[1])
    return [statistics.median(x) for x in samples]


class ParentKernels:
    """K1, K5, K7, K3 and K4 as an earlier tree built them: its
    csrc/pathtrace.cu, intersect.cu, megakernel.cu and culled.cu (a `git
    archive` of that commit unpacked under the gitignored build/), compiled
    with this tree's nvcc flags and bound through this tree's wrappers (the
    C signatures of `pathtrace_forward`, `triangle_nearest`,
    `sphere_nearest`, `fused_shade`, `culled_nearest` and `culled_occluded`
    have not changed), so that old and new kernels are timed in turns in
    one run. (K7 shares K5's per-pair epilogue, mesh_math.cuh `brute_t`,
    and K3, K4 and K7 the cluster walk, cluster_walk.cuh; the parent's
    intersect.cu carries its K6 too.)"""

    SOURCES = ("pathtrace", "intersect", "megakernel", "culled")

    def __init__(self, csrc):
        import ctypes

        from skele_raytracer_tpu_torch.ops.cuda import _build

        self.csrc = csrc
        out = os.path.join(REPO, "build", "parent_kernels")
        os.makedirs(out, exist_ok=True)
        self.paths = {name: os.path.join(out, f"{name}.so")
                      for name in self.SOURCES}
        procs = {name: subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
             self.paths[name], os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name in self.SOURCES}
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            check(proc.returncode == 0,
                  f"parent {name}.cu build failed:\n{err}")
            for line in ptxas_summary(err):
                print(f"[ptxas] parent {name}: {line}")
        pt, culled, k5, mk = kernel_modules()
        self.libs = {pt: pt.bind(ctypes.CDLL(self.paths["pathtrace"])),
                     k5: k5.bind(ctypes.CDLL(self.paths["intersect"])),
                     mk: mk.bind(ctypes.CDLL(self.paths["megakernel"])),
                     culled: culled.bind(ctypes.CDLL(self.paths["culled"]))}
        names = ", ".join(f"{n}.cu" for n in self.SOURCES)
        print(f"[build] the parent tree's {names} from {csrc}")

    def call(self, mod, fn):
        """fn() with `mod`'s wrappers launching the parent's library (K1's
        for ops/cuda/pathtrace.py, K5's for ops/cuda/intersect.py, K7's for
        ops/cuda/megakernel.py, K3's and K4's for ops/cuda/culled.py);
        `mod` None: every module's."""
        mods = list(self.libs) if mod is None else [mod]
        saved = [m._lib for m in mods]
        for m in mods:
            m._lib = self.libs[m]
        try:
            return fn()
        finally:
            for m, lib in zip(mods, saved):
                m._lib = lib


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


def names_kernel(tag, key):
    """Whether the profiler row `key` is the kernel `tag`: its name holds
    tag, and a tag without template arguments is not one of a template's
    instantiations ("occluded_kernel" is not "occluded_kernel<16>")."""
    i = key.find(tag)
    while i >= 0:
        if "<" in tag or key[i + len(tag):i + len(tag) + 1] != "<":
            return True
        i = key.find(tag, i + 1)
    return False


def device_ms(fns, reps=10):
    """Mean device time (ms) per launch of the kernels that `fns` launch
    ({tag: fn}: fn launches one kernel whose name holds tag), from
    torch.profiler over `reps` rounds of calls in turns (forward, then
    backward through the list), after a warm-up call each. Unlike CUDA
    events around one call, it leaves out the wrapper's host time, which a
    kernel of a tenth of a millisecond does not hide. A trace that loses
    launches is retaken up to 3 times; then each kernel is timed by CUDA
    events over `reps` back-to-back calls, and a `[profile]` line says
    so."""
    items = list(fns.items())

    def warm():
        for _, fn in items:
            fn()

    def rounds():
        for rnd in range(reps):
            for _, fn in (items if rnd % 2 == 0 else items[::-1]):
                fn()

    warm()
    torch.cuda.synchronize()
    for attempt in range(3):  # a trace may lose a kernel's records
        events = device_events(rounds, warm)
        out, missed = {}, []
        for tag, _ in items:  # the trace may miss a launch at its start
            hit = [e for e in events if names_kernel(tag, e.key)]
            count = sum(e.count for e in hit)
            if not reps // 2 <= count <= reps:
                missed.append(f"{count} launches of {tag}")
                continue
            out[tag] = sum(dev_us(e) for e in hit) / 1e3 / count
        if not missed:
            return out
        print(f"[profile] trace {attempt + 1} of 3 held "
              f"{', '.join(missed)}, want {reps}; rows: "
              + "; ".join(f"{e.key[:80]} x{e.count}" for e in events))
    # CUPTI lost the launches three times over: CUDA events around `reps`
    # back-to-back calls of each instead, which include the wrapper's host
    # time where it exceeds the kernel's
    out = {}
    for tag, fn in items:
        _, ms = timed(lambda: [fn() for _ in range(reps)])
        out[tag] = ms / reps
    print(f"[profile] the profiler lost these launches: device ms per "
          f"launch by CUDA events over {reps} back-to-back calls instead: "
          + ", ".join(f"{tag} {ms:.4f}" for tag, ms in out.items()))
    return out


def time_redesigned(name, label, n, smi, kernel, tag, plain, work, parent,
                    mod, parent_tag, equal, lanes_for=None, lanes=None):
    """A redesigned kernel (K3, K4, K5 or K7) alone at one wave of n rays.
    `kernel(lanes)` launches it with that many lanes per ray (None: the
    launcher's choice), whose kernel is named `tag(lanes)`. Prints its
    device time per launch (`device_ms`) at each lane count of `lanes`
    (culled.LANES by default; `[tune]`) and, with `parent`, the parent
    tree's kernel's (named `parent_tag`) on the same inputs in the same
    turns (their outputs must agree: `equal(new, old)`; `parent_tag`
    None: its kernel has this tree's name, so only its calls are timed);
    the time of one wrapper call by CUDA events, in turns with the
    parent's; the plain version's; the bound and the shares of it.
    Returns (device ms at the launcher's choice, plain_ms, bound_ms,
    bound_by, the parent's device ms or None). `lanes_for`: the
    launcher's rule (culled.lanes_for by default)."""
    _, culled, _, _ = kernel_modules()
    lanes_for = lanes_for or culled.lanes_for
    lanes = lanes or culled.LANES
    # the launcher's own lane count through the launcher's entry
    fns = {tag(g): (lambda g=g: kernel(None if g == lanes_for(n) else g))
           for g in lanes}
    calls = [lambda: kernel(None)]
    if parent is not None:
        check(equal(kernel(None), parent.call(mod, lambda: kernel(None))),
              f"{name} {label}: the parent tree's kernel disagrees")
        calls.append(lambda: parent.call(mod, lambda: kernel(None)))
        if parent_tag is not None:  # a name of its own in the profiler
            fns[parent_tag] = calls[-1]
    dev = device_ms(fns)
    call_ms = turns_ms(calls)
    ms = dev[tag(lanes_for(n))]
    old_ms = dev.get(parent_tag)
    plain_ms = median_ms(plain, 3)
    b_ms, b_by = work
    old_txt = ("" if parent is None else
               f"; the parent tree's kernel, one call {call_ms[1]:.4f} ms"
               if old_ms is None else
               f"; the parent tree's kernel {old_ms:.4f} ms "
               f"({b_ms / old_ms:.2%} of the bound), one call "
               f"{call_ms[1]:.4f} ms")
    print(f"[time] {name} {label} on {smi}: kernel {ms:.4f} ms of device "
          f"time per launch ({b_ms / ms:.2%} of the bound), one call "
          f"{call_ms[0]:.4f} ms{old_txt} (profiler, 10 launches each, and "
          f"CUDA events, median of 10 each, in turns); plain PyTorch "
          f"{plain_ms:.3f} ms (median of 3 warm runs); bound {b_ms:.4f} ms by "
          f"{b_by}")
    print(f"[tune] {name} {label}: device ms per launch at lanes per ray "
          + ", ".join(f"{g}: {dev[tag(g)]:.4f}" for g in lanes)
          + f" (the launcher picks {lanes_for(n)})")
    return ms, plain_ms, b_ms, b_by, old_ms


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a GPU", file=sys.stderr)
        raise SystemExit(1)
    smi = nvidia_smi_line()
    print(f"[device] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.device_count()} visible")
    return smi


def phase_build():
    from skele_raytracer_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    for mod in counted_modules():
        mod.build_kernel()
    kernel_modules()[0].build_backward_kernel()
    kernel_modules()[0].build_sweep_kernel()
    kernel_modules()[1].build_sweep_kernel()
    dt = time.perf_counter() - t0
    each = ", ".join(f"{name} {sec:.2f} s" for name, sec in secs.items())
    print(f"[build] {', '.join(_build.CUDA_LIBRARIES)} from {_build.CSRC} "
          f"with nvcc {' '.join(_build.NVCC_FLAGS)}, in parallel: {each}; "
          f"{dt:.2f} s with load")
    for name, log in _build.build_logs.items():
        for line in ptxas_summary(log):
            print(f"[ptxas] {name}: {line}")


def kernel_label(text):
    """The kernel named by a mangled symbol in `text`, with its template
    arguments (nearest_kernel<8>, fused_kernel<4, true>), or None."""
    import re

    m = re.search(r"\w*?\d+((?:lab_v\d|[a-z_])[a-z_]*_kernel)"
                  r"(I(?:L[bi]\d+E)+E)?", text)
    if not m:
        return None
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([bi])(\d+)E", m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_summary(log):
    """One line per kernel from `-Xptxas -v` output: registers, shared
    memory, stack and spills (ptxas prints the stack/spill line, then the
    register line, after each kernel's `Compiling entry function`), named
    by `kernel_label`."""
    out, kernel, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line.split("'")[1])
            frame = ""
        elif kernel and "spill stores" in line:
            frame = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {frame}")
            kernel = None
    return out


def sass_scan_loops(path):
    """{kernel: [(instructions, MUFU instructions) of each innermost loop
    that holds a square root or a reciprocal (MUFU.RSQ, MUFU.RCP): the
    scan loops]} of a built library, from `cuobjdump -sass`; None where
    the toolkit has no cuobjdump. A loop is the span from a backward
    branch's target to the branch."""
    import re

    from skele_raytracer_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for body in text.split("Function : ")[1:]:
        name = kernel_label(body.split("\n", 1)[0])
        if name is None:
            continue
        ins, labels, pending = [], {}, []
        for line in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                addr = int(m.group(1), 16)
                for lb in pending:
                    labels[lb] = addr
                pending = []
                ins.append((addr, m.group(2)))
        loops = []
        for addr, op in ins:
            b = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))",
                          op)
            if not b:
                continue
            target = labels.get(b.group(1)) if b.group(1) else int(b.group(2),
                                                                   16)
            if target is not None and target <= addr:
                loops.append((target, addr))
        for lo, hi in loops:
            if any(lo <= a and b2 <= hi for a, b2 in loops
                   if (a, b2) != (lo, hi)):
                continue  # holds another loop: not innermost
            body_ops = [op for a, op in ins if lo <= a <= hi]
            mufu = sum("MUFU" in op for op in body_ops)
            if any("MUFU.RSQ" in op or "MUFU.RCP" in op for op in body_ops):
                out.setdefault(name, []).append((len(body_ops), mufu))
    return out


def phase_sass(parent=None):
    """`[sass]`: the scan loops of K1 (pathtrace_kernel) and K5
    (triangle_kernel) in this tree's libraries and, with `parent`, the
    parent tree's (`sass_scan_loops`); their registers and spills are the
    `[ptxas]` lines."""
    from skele_raytracer_tpu_torch.ops.cuda import _build

    libs = ("pathtrace", "intersect")
    trees = [("this tree", {n: _build.build_cuda(n) for n in libs})]
    if parent is not None:
        trees.append(("parent", {n: parent.paths[n] for n in libs}))
    for tree, paths in trees:
        for lib, path in paths.items():
            loops = sass_scan_loops(path)
            if loops is None:
                print(f"[sass] {tree} {lib}: not measured (no cuobjdump)")
                return
            for name, spans in loops.items():
                if name.startswith(("pathtrace_kernel", "triangle_kernel")):
                    print(f"[sass] {tree} {name}: innermost loops with a "
                          f"square root or reciprocal, (instructions, MUFU): "
                          + ", ".join(f"({a}, {b})" for a, b in spans))


# the lab instances whose registers and spills `phase_sass_lab` prints side
# by side: every instance of the split walk (L3, L5; L5 at G 4 holds one
# stage of 16-row blocks), L6, L1 at G 4
LAB_PTXAS = tuple(f"{k}_kernel<{p}, {g}>" for k in ("lab_base", "lab_flat")
                  for p in (6, 3) for g in (1, 2, 4)) + (
    "lab_presplit_kernel<2>", "lab_v6_kernel<3, 4>")


# the lab kernels that walk a tile per block (L1, L2, L4, L6)
LAB_TILE_KERNELS = ("lab_v6_kernel", "lab_v5_kernel", "lab_probe_kernel",
                    "lab_presplit_kernel")


def sass_functions(path):
    """{kernel label: [its SASS instructions, without addresses and
    encodings]} of a built library, from `cuobjdump -sass`; None where the
    toolkit has no cuobjdump."""
    import re

    from skele_raytracer_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for body in text.split("Function : ")[1:]:
        head, rest = body.split("\n", 1)
        name = kernel_label(head)
        if name:
            out[name] = [m.group(1) for m in (
                re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
                for line in rest.splitlines()) if m]
    return out


def lab_sass_against(csrc):
    """`[sass]`: the tile-walk instances (LAB_TILE_KERNELS) of this tree's
    culled_lab library against those of an earlier tree's culled_lab.cu
    (`csrc`, built with this tree's nvcc flags), function by function:
    identical or not, with their instruction counts. Returns the names
    that differ."""
    from skele_raytracer_tpu_torch.ops.cuda import _build

    out = os.path.join(REPO, "build", "parent_kernels", "culled_lab.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out,
         os.path.join(csrc, "culled_lab.cu")], capture_output=True,
        text=True, timeout=600)
    check(proc.returncode == 0,
          f"parent culled_lab.cu build failed:\n{proc.stderr}")
    mine = sass_functions(_build.build_cuda("culled_lab"))
    theirs = sass_functions(out)
    if mine is None:
        print("[sass] culled_lab against the parent: not measured (no "
              "cuobjdump)")
        return []
    names = sorted(n for n in theirs if n.startswith(LAB_TILE_KERNELS))
    differ = [n for n in names if mine.get(n) != theirs[n]]
    print(f"[sass] culled_lab's tile-walk instances against the parent's "
          f"({csrc}): {len(names) - len(differ)} of {len(names)} identical"
          + "".join(f"; {n} differs ({len(mine.get(n, []))} against "
                    f"{len(theirs[n])} instructions)" for n in differ))
    return differ


def phase_sass_lab(parent=None):
    """`[sass]`: the tensor-core instructions (HMMA) of every instance of
    the kernel lab's L1, L2, L5 and L6 (culled_lab.cu lab_v6_kernel,
    lab_v5_kernel, lab_flat_kernel, lab_presplit_kernel) in the built
    library: each bf16x3 (passes 3) instance must hold them, which shows
    that its product runs on the tensor cores; the registers, spills
    and static shared memory of LAB_PTXAS from the build's ptxas lines;
    with `parent`, `lab_sass_against` its csrc."""
    from skele_raytracer_tpu_torch.ops.cuda import _build

    log = _build.build_logs.get("culled_lab")
    lines = {} if log is None else {
        line.split(":", 1)[0]: line for line in ptxas_summary(log)}
    for name in LAB_PTXAS:
        print(f"[sass] {lines.get(name, name + ': not measured (no build log)')}")
    funcs = sass_functions(_build.build_cuda("culled_lab"))
    if funcs is None:
        print("[sass] culled_lab: not measured (no cuobjdump)")
        return
    if parent is not None:
        lab_sass_against(parent.csrc)
    counts = {name: sum("HMMA" in op for op in ops)
              for name, ops in funcs.items()
              if name.startswith(("lab_v6_kernel", "lab_v5_kernel",
                                  "lab_flat_kernel", "lab_presplit_kernel"))}
    print("[sass] culled_lab HMMA instructions: "
          + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    p3 = {k: v for k, v in counts.items()
          if k.startswith("lab_presplit") or "<3," in k}
    check(len(p3) == 12 and all(p3.values()),
          f"L1/L2/L5/L6's bf16x3 instances lack tensor-core instructions: "
          f"{counts}")


def phase_k1_headlines(smi, parent=None):
    """K1 at the 1080p headlines, parity and clean (2,073,600 samples,
    gillum 16, depth 2, shadows): the forward-only kernel and the records
    variant by CUDA events around one wrapper call (median of 6, in
    turns), each beside its bound (`k1_work`); `[tune]`: every
    forward-only variant of the measurement build (pt.sweep_variants:
    rows per scan step, threads and blocks per SM),
    each bitwise equal to the kernel, in the same turns; the share of
    bounce records that miss. With `parent`, the parent tree's K1, forward
    and records, on the same inputs: r, g, b and records bitwise equal to
    this tree's, and timed in the same turns, as is `render` end to end
    through each tree's K1. Returns {mode: times}."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    variants = pt.sweep_variants()
    out = {}
    for mode, quirks in (("parity", PARITY), ("clean", CLEAN)):
        scene, cfg = headline(quirks)
        n = cfg.width * cfg.height * cfg.samples_per_pixel
        tabs = pt._pack_tables(scene)
        planes = pt._plane_inputs(cfg, torch.arange(n, device="cuda"))
        static = pt._static_kernel_args(scene, cfg)
        fwd = lambda: pt.pathtrace_forward(tabs, planes, 0, static)
        rec = lambda: pt.pathtrace_forward(tabs, planes, 0, static,
                                           records=True)
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
        new, new_r = fwd(), rec()
        check(same(new, new_r[:3]), f"K1 {mode}: the records variant's "
              f"radiance differs from the forward's")
        bounce = new_r[3][1:]
        miss = ((bounce >> 8) & 1).eq(0).float().mean().item()
        fns = {"kernel": fwd, "records": rec}
        if parent is not None:
            check(same(new, parent.call(pt, fwd)),
                  f"K1 {mode}: r, g, b differ from the parent tree's")
            check(same(new_r, parent.call(pt, rec)),
                  f"K1 {mode}: records (or their radiance) differ from the "
                  f"parent tree's")
            fns["parent kernel"] = lambda: parent.call(pt, fwd)
            fns["parent records"] = lambda: parent.call(pt, rec)
            frame = lambda: render(scene, cfg, seed=0)
            fns["render"] = frame
            fns["parent render"] = lambda: parent.call(pt, frame)
        for v, name in enumerate(variants):
            run = lambda v=v: pt.pathtrace_forward(tabs, planes, 0, static,
                                                   variant=v)
            check(same(new, run()), f"K1 {mode}: variant {name} differs")
            fns[name] = run
        ms = dict(zip(fns, turns_ms(list(fns.values()), reps=6)))
        b_ms, b_by = k1_work(static, n)
        br_ms, br_by = k1_work(static, n, records=True)
        old = ("" if parent is None else
               f"; the parent tree's kernel {ms['parent kernel']:.4f} ms, "
               f"records {ms['parent records']:.4f} ms (bitwise equal: r, "
               f"g, b and {new_r[3].shape[0]} x {n} records); "
               f"{ms['parent kernel'] / ms['kernel']:.2f}x and "
               f"{ms['parent records'] / ms['records']:.2f}x; `render` end "
               f"to end {ms['render']:.4f} ms, through the parent tree's K1 "
               f"{ms['parent render']:.4f} ms")
        print(f"[time] pathtrace 1920x1080 {mode} gillum16 depth2 shadows "
              f"({n} samples) on {smi}: kernel {ms['kernel']:.4f} ms "
              f"({b_ms / ms['kernel']:.2%} of its bound {b_ms:.4f} ms by "
              f"{b_by}), records variant {ms['records']:.4f} ms "
              f"({br_ms / ms['records']:.2%} of {br_ms:.4f} ms by {br_by})"
              f"{old} (CUDA events around one call, median of 6, in turns)")
        print(f"[tune] pathtrace 1920x1080 {mode}: ms per call, forward only "
              f"(bitwise equal to the kernel): "
              + ", ".join(f"{v}: {ms[v]:.4f}" for v in variants)
              + f"; the kernel {ms['kernel']:.4f} ({pt.kernel_config()})")
        print(f"[k1] {mode} 1080p: {miss:.4f} of the {bounce.numel()} bounce "
              f"records miss every primitive")
        out[mode] = dict(ms, bound=(b_ms, b_by), rec_bound=(br_ms, br_by),
                         miss=miss)
    return out


def k2_launcher_lanes(static, n):
    """Lanes per sample K2's launcher takes for n samples (the library's
    `pathtrace_bwd_lanes_for`)."""
    import ctypes

    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    return pt.build_backward_kernel().pathtrace_bwd_lanes_for(
        ctypes.byref(pt._params(n, 0, static)))


def check_k2(label, tabs, planes, static, seed=7, lanes=(None,)):
    """K1's records variant and K2 against their plain versions on the
    same tensors: records bitwise, the records variant's radiance equal to
    the forward-only kernel's, K2 per table within GRAD_RTOL max|plain| +
    GRAD_ATOL, and two K2 runs bitwise equal, at each of `lanes` (lanes per
    sample; None: the launcher's choice). Returns (worst K1-records
    |radiance diff| vs plain, worst K2 |diff|)."""
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    n = planes[0].shape[0]
    *rad, rec = launched(pt, "pathtrace_records", lambda: pt.pathtrace_forward(
        tabs, planes, seed, static, records=True))
    fwd = pt.pathtrace_forward(tabs, planes, seed, static)
    check(all(torch.equal(a, b) for a, b in zip(rad, fwd)),
          f"{label}: records variant's radiance differs from the forward's")
    *prad, prec = pt.frame_math_torch(tabs, planes, seed, emit_records=True,
                                      **static)
    check(torch.equal(rec, prec), f"{label}: records differ on "
          f"{(rec != prec).sum().item()} of {rec.numel()}")
    rec_err = max((a - b).abs().max().item() for a, b in zip(rad, prad))
    g = torch.randn(n, 3, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    plain = pt.replay_table_grads(tabs, planes, rec, g, seed, static)
    worst, rel = 0.0, 0.0
    for lane in lanes:
        k = launched(pt, "pathtrace_bwd", lambda: pt.pathtrace_backward(
            tabs, planes, rec, g, seed, static, lanes=lane))
        k2 = pt.pathtrace_backward(tabs, planes, rec, g, seed, static,
                                   lanes=lane)
        for name, a, b, w in zip(("sph", "tri", "misc", "pl", "dl"), k, k2,
                                 plain):
            check(torch.equal(a, b),
                  f"{label}: K2 {name} differs between runs (lanes {lane})")
            err = (a - w).abs().max().item()
            scale = w.abs().max().item()
            check(err <= GRAD_RTOL * scale + GRAD_ATOL,
                  f"{label}: K2 {name} off by {err:.3e} (max |plain| "
                  f"{scale:.3e}, lanes {lane})")
            worst = max(worst, err)
            rel = max(rel, err / max(scale, 1e-30))
    each = ("" if lanes == (None,) else
            f" at lanes per sample {', '.join(str(x) for x in lanes)} "
            f"(None: the launcher's {k2_launcher_lanes(static, n)})")
    print(f"[kernel-vs-plain] {label}: K1 records bitwise equal "
          f"({rec.shape[0]} x {n}), radiance equal to the forward-only "
          f"kernel's; K2{each} vs autograd of the plain replay: worst |diff| "
          f"{worst:.3e}, worst |diff|/max|plain| {rel:.3e}, two runs "
          f"bitwise equal (ok)")
    return rec_err, worst


def phase_kernel_vs_plain():
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    worst = dict(pathtrace=0.0, pathtrace_records=0.0, pathtrace_bwd=0.0)
    for name, scene_name, overrides in KERNEL_CASES:
        scene, cfg = case_scene_and_config(scene_name, overrides, 64, 36,
                                           "cuda")
        ids = torch.arange(64 * 36 * cfg.samples_per_pixel, device="cuda")
        tabs = pt._pack_tables(scene)
        planes = pt._plane_inputs(cfg, ids)
        static = pt._static_kernel_args(scene, cfg)
        before = pt.LAUNCHES["pathtrace"]
        k = torch.stack(pt.pathtrace_forward(tabs, planes, 7, static), 1)
        torch.cuda.synchronize()
        check(pt.LAUNCHES["pathtrace"] == before + 1,
              f"{name}: the kernel was not launched")
        ref = torch.stack(pt.frame_math_torch(tabs, planes, 7, **static), 1)
        frac, err, mdiff, ok = compare(k, ref)
        worst["pathtrace"] = max(worst["pathtrace"], err)
        print(f"[kernel-vs-plain] {name} 64x36: {frac:.4%} of values off by "
              f">{ATOL:g}, max |diff| {err:.3e}, mean diff {mdiff:.2e} "
              f"({'ok' if ok else 'FAIL'})")
        check(ok, f"{name}: kernel disagrees with the plain version")
        rec_err, k2_err = check_k2(f"{name} 64x36", tabs, planes, static)
        worst["pathtrace_records"] = max(worst["pathtrace_records"], rec_err)
        worst["pathtrace_bwd"] = max(worst["pathtrace_bwd"], k2_err)
    return worst


def phase_k2_headline():
    """K1 records and K2 against their plain versions on 65,536 ids of the
    1080p headline, parity and clean (live fog, 2 point lights, shadows),
    K2 at each lane count of pt.BWD_LANES and the launcher's. Returns the
    worst (K1 records, K2) differences."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    worst = [0.0, 0.0]
    for mode, quirks in (("parity", PARITY), ("clean", CLEAN)):
        scene, cfg = headline(quirks)
        # 65,536 ids from row 540 on: spheres, lights and fog (the first
        # rows of the frame are sky)
        start = 540 * cfg.width
        ids = torch.arange(start, start + (1 << 16), device="cuda")
        tabs = pt._pack_tables(scene)
        planes = pt._plane_inputs(cfg, ids)
        static = pt._static_kernel_args(scene, cfg)
        errs = check_k2(f"spheres2 1080p {mode} gillum16 depth2 shadows, "
                        f"65,536 ids from row 540", tabs, planes, static,
                        lanes=(None, *pt.BWD_LANES))
        *_, rec = pt.pathtrace_forward(tabs, planes, 7, static, records=True)
        g = torch.randn(ids.shape[0], 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
        for n in (1 << 16, 4096):  # batches that leave SMs idle, or nearly
            cut = tuple(p[:n] for p in planes)
            tune = {lanes: median_ms(lambda lanes=lanes: pt.pathtrace_backward(
                tabs, cut, rec[:, :n].contiguous(), g[:n].contiguous(), 7,
                static, lanes=lanes), 5) for lanes in pt.BWD_LANES}
            print(f"[tune] pathtrace_bwd spheres2 1080p {mode}, {n} ids from "
                  f"row 540: ms per call at lanes per sample "
                  + ", ".join(f"{k}: {v:.4f}" for k, v in tune.items())
                  + f" (CUDA events, median of 5; the launcher picks "
                  f"{k2_launcher_lanes(static, n)})")
        worst = [max(a, b) for a, b in zip(worst, errs)]
    return worst


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


def dragon_waves(quirks, ids, paths, scene=None):
    """Dragon's waves at 640x480 (of `scene`, by default dragon.scn on the
    ids' device) for the sample ids (`mesh_waves`)."""
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    if scene is None:
        scene = parse_scene(os.path.join(SCENES, "dragon.scn")).to_scene(
            quirks, device=ids.device)
    return scene, mesh_waves(scene, quirks, 640, 480, ids, paths)


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


def phase_mesh_kernels_vs_plain():
    """K3, K4 and K5 against their plain versions on the card. Returns
    the worst |t diff| (K3, K5) and |occlusion diff| (K4)."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY
    from skele_raytracer_tpu_torch.ops import accel

    _, culled, k5, _ = kernel_modules()
    worst = dict(culled_nearest=0.0, culled_occluded=0.0,
                 triangle_nearest=0.0)
    tris = synthetic_mesh(1100, 9, "cuda")
    o, d, live, bound = random_rays(CHUNK_RAYS, 4, "cuda")
    for cs in (accel.CLUSTER_SIZE, accel.FINE_CLUSTER_SIZE):
        mesh = accel.build_clusters(*tris, cluster_size=cs)
        for q, mode in ((PARITY, "parity"), (CLEAN, "clean")):
            for lv in (None, live):
                got = launched(culled, "culled_nearest",
                               lambda: culled.triangle_nearest_culled(
                                   o, d, mesh, quirks=q, live=lv))
                err, share = nearest_diff(got, plain_culled_nearest(
                    o, d, mesh, q, lv))
                worst["culled_nearest"] = max(worst["culled_nearest"], err)
                for tm in (None, bound):
                    occ = launched(culled, "culled_occluded",
                                   lambda: culled.triangle_occluded(
                                       o, d, mesh, quirks=q, t_max=tm,
                                       live=lv))
                    want = plain_occluded(o, d, mesh, q, tm, lv)
                    check(torch.equal(occ, want),
                          f"K4 differs on {(occ != want).sum()} rays")
                print(f"[kernel-vs-plain] K3/K4 synthetic 1100 tris cs {cs} "
                      f"{mode} live={lv is not None}: {CHUNK_RAYS} rays, "
                      f"{share:.3f} hit, max |t diff| {err:.3e}; K4 "
                      f"unbounded and bounded identical (ok)")
    small = synthetic_mesh(700, 2, "cuda")
    for q, mode in ((PARITY, "parity"), (CLEAN, "clean")):
        got = launched(k5, "triangle_nearest",
                       lambda: k5.triangle_nearest(o, d, *small, quirks=q))
        want = plain_triangle_nearest(o, d, small, q)
        err, share = nearest_diff(got[:3], want[:3])
        h = got[2]
        check(torch.equal(got[3][h], want[3][h])
              and torch.equal(got[4][h], want[4][h]), "K5 u, v differ")
        worst["triangle_nearest"] = max(worst["triangle_nearest"], err)
        print(f"[kernel-vs-plain] K5 synthetic 700 tris {mode}: {CHUNK_RAYS} "
              f"rays, {share:.3f} hit, max |t diff| {err:.3e}, u v "
              f"identical (ok)")
    feats, rec = tied_k5_case("cuda")
    for sign, clip, mode in ((1.0, False, "parity"), (-1.0, True, "clean")):
        want = k5.triangle_nearest_torch(feats, rec, sign=sign, clip=clip)
        for g in (None, *k5.LANES):
            got = launched(k5, "triangle_nearest",
                           lambda: k5.triangle_nearest_kernel(
                               feats, rec, sign=sign, clip=clip, lanes=g))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K5 {mode} lanes {g}: t, index, u or v differ from the "
                  f"plain version")
        hit = want[0] < k5.BIG
        print(f"[kernel-vs-plain] K5 {mode} at lanes per ray None (the "
              f"launcher's {k5.launcher_lanes()}), "
              f"{', '.join(map(str, k5.LANES))}: {feats.shape[0]} rays x "
              f"{rec.shape[0]} tris with exact-t ties "
              f"({hit.float().mean():.3f} hit, every winner the earlier copy: "
              f"{bool((want[1][hit] < rec.shape[0] // 2).all())}), t, index, "
              f"u, v bitwise equal to the plain version (ok)")

    ids = torch.arange(640 * 480, device="cuda")
    for q, mode in ((PARITY, "parity"), (CLEAN, "clean")):
        scene, waves = dragon_waves(q, ids, 1)
        o, d = waves["primary"]
        got = launched(culled, "culled_nearest",
                       lambda: culled.triangle_nearest_culled(
                           o, d, scene.clusters, quirks=q))
        err, share = nearest_diff(got, plain_culled_nearest(
            o, d, scene.clusters, q))
        o1, d1, lv = waves["bounce"]
        got = launched(culled, "culled_nearest",
                       lambda: culled.triangle_nearest_culled(
                           o1, d1, scene.clusters_fine, quirks=q, live=lv))
        err1, share1 = nearest_diff(got, plain_culled_nearest(
            o1, d1, scene.clusters_fine, q, lv))
        worst["culled_nearest"] = max(worst["culled_nearest"], err, err1)
        line = (f"[kernel-vs-plain] dragon 640x480 {mode}: K3 primary "
                f"(coarse, {scene.clusters.n_clusters} clusters) {share:.3f} "
                f"hit, max |t diff| {err:.3e}; K3 bounce (fine, "
                f"{scene.clusters_fine.n_clusters} clusters, "
                f"{lv.mean().item():.3f} live) {share1:.3f} hit, max |t "
                f"diff| {err1:.3e}")
        if "shadow" in waves:
            so, sd, slv = waves["shadow"]
            occ = launched(culled, "culled_occluded",
                           lambda: culled.triangle_occluded(
                               so, sd, scene.clusters_fine, quirks=q,
                               live=slv))
            want = plain_occluded(so, sd, scene.clusters_fine, q, None, slv)
            check(torch.equal(occ, want),
                  f"dragon K4 differs on {(occ != want).sum()} rays")
            line += (f"; K4 bounce shadows {slv.mean().item():.3f} live, "
                     f"{occ.float().mean().item():.3f} occluded, identical")
        print(line + " (ok)")
    return worst


def phase_goldens():
    from skele_raytracer_tpu_torch.config import RenderConfig
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.scene.parser import parse_scene
    from skele_raytracer_tpu_torch.utils.image import quantize

    for golden, scn, shadow, w, h, depth in BYTE_GOLDENS + MESH_GOLDENS:
        ref = read_golden_ppm(golden)
        cfg = RenderConfig(width=w, height=h, max_depth=depth,
                           use_shadows=shadow, backend="cuda")
        scene = parse_scene(os.path.join(SCENES, scn)).to_scene(
            cfg.quirks, device="cuda")
        ours = quantize(render(scene, cfg).cpu().numpy())
        exact = float((ours == ref).all(axis=2).mean())
        print(f"[golden] {golden}: {exact:.4%} of {w}x{h} pixels "
              f"byte-identical")
        check(exact >= MIN_EXACT, f"{golden}: only {exact:.4%} identical")

    data = np.load(os.path.join(GOLDENS, "spheres2_gillum16_shadows_128.npz"))
    cfg = RenderConfig(width=128, height=96, monte_carlo=True, num_paths=16,
                       max_depth=2, use_shadows=True, backend="cuda")
    scene = parse_scene(os.path.join(SCENES, "spheres2.scn")).to_scene(
        cfg.quirks, device="cuda")
    frames = np.stack([quantize(render(scene, cfg, seed=k).cpu().numpy())
                       for k in range(8)])
    bad, bias = stochastic_bad_fraction(
        data["mean"].astype(np.float64), data["var"].astype(np.float64),
        int(data["n"]), frames)
    print(f"[golden] spheres2_gillum16_shadows_128 (8 seeds, whole frame): "
          f"{bad:.3%} of channel values outside 3 sigma, bias {bias:.3f} LSB")
    check(bad <= 0.01 and bias < 0.25, "stochastic golden failed")


def _frame_timings(label, scene, cfg, smi):
    """Kernel alone vs plain vs `render` end to end at cfg's size; checks
    render's radiance against the plain version. Returns the numbers."""
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    n = cfg.width * cfg.height * cfg.samples_per_pixel
    ids = torch.arange(n, device="cuda")
    tabs = pt._pack_tables(scene)
    planes = pt._plane_inputs(cfg, ids)
    static = pt._static_kernel_args(scene, cfg)

    img = render(scene, cfg, seed=0)
    ref = torch.stack(pt.frame_math_torch(tabs, planes, 0, **static), 1)
    frac, err, mdiff, ok = compare(img.reshape(-1, 3), ref)
    print(f"[main] {label}: render vs plain {frac:.4%} off by >{ATOL:g}, "
          f"max |diff| {err:.3e}, mean diff {mdiff:.2e} "
          f"({'ok' if ok else 'FAIL'})")
    check(ok, f"{label}: render disagrees with the plain version")
    del ref

    kernel = lambda: pt.pathtrace_forward(tabs, planes, 0, static)
    plain = lambda: pt.frame_math_torch(tabs, planes, 0, **static)
    frame = lambda: render(scene, cfg, seed=0)
    for fn in (kernel, frame, plain):  # warm up
        fn()
    torch.cuda.synchronize()
    k_ms = statistics.median(cuda_ms(kernel, 5))
    r_ms = statistics.median(cuda_ms(frame, 5))
    p_ms = statistics.median(cuda_ms(plain, 3))
    rays = n / (r_ms / 1e3)
    print(f"[main] {label} on {smi}: kernel {k_ms:.4f} ms, render end to "
          f"end {r_ms:.4f} ms ({rays:,.0f} primary rays/s, "
          f"{rays * (1 + cfg.paths_per_sample * (cfg.max_depth - 1)):,.0f} "
          f"ray segments/s), plain PyTorch {p_ms:.2f} ms "
          f"(median of 5, 5, 3 warm runs)")
    return dict(kernel_ms=k_ms, render_ms=r_ms, plain_ms=p_ms, err=err)


def check_ppm(path, w, h):
    header = f"P6\n{w} {h}\n255\n".encode()
    with open(path, "rb") as f:
        got = f.read(len(header))
    check(got == header, f"bad PPM header {got!r}")
    check(os.path.getsize(path) == len(header) + w * h * 3,
          "PPM size is wrong")


def phase_main_path(smi):
    from skele_raytracer_tpu_torch import cli
    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    os.makedirs(SCRATCH, exist_ok=True)
    out = os.path.join(SCRATCH, "out.ppm")
    argv = ["--path", os.path.join(SCENES, "spheres2.scn"), "--output", out,
            "--width", "1920", "--height", "1080", "--shadow", "--gillum",
            "16", "--depth", "2"]
    reset_launches()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    check(rc == 0, f"cli.main returned {rc}")
    check_ppm(out, 1920, 1080)
    check(launches["pathtrace"] > 0 and sum(launches.values()) ==
          launches["pathtrace"],
          f"the K1 path did not launch just its kernel: {launches}")
    print(f"[main] cli.main {' '.join(argv)} -> rc {rc}, P6 1920x1080, "
          f"launches {launches}")

    parsed = parse_scene(os.path.join(SCENES, "spheres2.scn"))
    base = dict(width=1920, height=1080, monte_carlo=True, num_paths=16,
                max_depth=2, use_shadows=True, backend="cuda")
    cfg = RenderConfig(**base)
    parity = _frame_timings("spheres2 1080p parity gillum16 depth2 shadows",
                            parsed.to_scene(cfg.quirks, device="cuda"), cfg,
                            smi)
    cfg_c = RenderConfig(quirks=CLEAN, **base)
    scene_c = parsed.to_scene(CLEAN, device="cuda")
    check(scene_c.has_fog and not scene_c.fog_zeroed,
          "clean spheres2 must carry live fog")
    rc = cli.main(argv + ["--mode", "clean"])
    check(rc == 0, f"cli.main --mode clean returned {rc}")
    _frame_timings("spheres2 1080p clean (live fog) gillum16 depth2 shadows",
                   scene_c, cfg_c, smi)
    return launches, parity


DRAGON_RUNS = [  # (label, CLI flags beyond --path/--output, K4 expected)
    ("clean gillum16", ["--mode", "clean", "--gillum", "16", "--depth", "2",
                        "--shadow"], True),
    ("parity", ["--depth", "2", "--shadow"], False),
]


def phase_mesh_main_path():
    """The dragon CLI runs and the synthetic-mesh render, each with the
    launch counters set to 0 just before and read just after; then
    `render_ids_chunked` on the card against the plain path (the same code
    on the CPU) on sampled ids. Returns the launch counts."""
    from skele_raytracer_tpu_torch import cli
    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
    from skele_raytracer_tpu_torch.models.renderer import (
        render,
        render_ids_chunked,
    )
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    os.makedirs(SCRATCH, exist_ok=True)
    counts = {}
    for label, flags, k4 in DRAGON_RUNS:
        out = os.path.join(SCRATCH, "dragon.ppm")
        argv = ["--path", os.path.join(SCENES, "dragon.scn"), "--output",
                out, "--width", "640", "--height", "480", *flags]
        reset_launches()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        launches = read_launches()
        check(rc == 0, f"cli.main returned {rc}")
        check_ppm(out, 640, 480)
        check(launches["culled_nearest"] > 0,
              f"dragon {label} did not launch K3: {launches}")
        check((launches["culled_occluded"] > 0) == k4,
              f"dragon {label}: K4 launches {launches['culled_occluded']}, "
              f"expected {'some' if k4 else 'none'}")
        check(launches["pathtrace"] == 0 and
              launches["triangle_nearest"] == 0 and
              not any(launches[k] for k in counted_modules()[-1].KERNELS),
              f"dragon {label} launched another path's kernel: {launches}")
        counts[label] = launches
        print(f"[main] cli.main {' '.join(argv)} -> rc {rc}, P6 640x480, "
              f"launches {launches}")

    scene = k5_mesh_scene(device="cuda")
    cfg = RenderConfig(width=256, height=256, quirks=CLEAN, monte_carlo=True,
                       num_paths=4, max_depth=2, use_shadows=True,
                       backend="cuda")
    reset_launches()
    img = render(scene, cfg, seed=0)
    torch.cuda.synchronize()
    launches = read_launches()
    check(tuple(img.shape) == (256, 256, 3) and bool(torch.isfinite(img)
                                                    .all()), "bad K5 frame")
    check(launches["triangle_nearest"] > 0 and launches["culled_nearest"] ==
          0, f"the synthetic mesh did not take K5 alone: {launches}")
    counts["k5"] = launches
    print(f"[main] render of a 700-triangle mesh (K5 route) 256x256 clean "
          f"gillum4 depth2 shadows: launches {launches}")

    rng = np.random.default_rng(0)
    for label, kw, n in (
            ("parity depth2 shadows", dict(max_depth=2, use_shadows=True),
             4096),
            ("clean gillum16 depth2 shadows",
             dict(quirks=CLEAN, monte_carlo=True, num_paths=16, max_depth=2,
                  use_shadows=True), 1024)):
        cfg = RenderConfig(width=640, height=480, backend="cuda", **kw)
        parsed = parse_scene(os.path.join(SCENES, "dragon.scn"))
        ids = torch.from_numpy(np.sort(rng.choice(640 * 480, n,
                                                  replace=False)))
        got = render_ids_chunked(parsed.to_scene(cfg.quirks, device="cuda"),
                                 cfg, 0, ids.cuda()).cpu()
        want = render_ids_chunked(parsed.to_scene(cfg.quirks),
                                  cfg.replace(backend="torch"), 0, ids)
        frac, err, mdiff, ok = compare(got, want)
        print(f"[main] dragon {label}: render_ids_chunked on the card vs "
              f"the plain path on the CPU, {n} sampled ids: {frac:.4%} off "
              f"by >{ATOL:g}, max |diff| {err:.3e}, mean diff {mdiff:.2e} "
              f"({'ok' if ok else 'FAIL'})")
        check(ok, f"dragon {label}: render disagrees with the plain path")
    return counts


def _sorted_wave(o, d, mesh, quirks, live=None, t_max=None):
    """A wave as the culled kernels receive it: features (and bound, live)
    in footprint order."""
    from skele_raytracer_tpu_torch.ops.cuda import culled

    lv = None if live is None else (live > 0).float()
    order, lv = culled._sort_rays(o, d, mesh, quirks, lv)
    feats = culled._ray_features10(o, d)[order].contiguous()
    bound = None if t_max is None else t_max[order].contiguous()
    return feats, bound, lv


def phase_mesh_timings(smi, parent=None):
    """Each mesh kernel alone and its plain version on the card, at one
    main-path chunk's shape (CUDA events, median of warm runs): K3 at
    dragon's parity primary chunk and at both waves of the clean gillum16
    chunk 37, K4 at that chunk's bounce and primary shadow waves, K5 at a
    65,536-ray chunk of a 700-triangle mesh (each `time_redesigned`; K5
    with `parent`, the parent tree's K5 in turns, bitwise equal); and
    `render` end to end for dragon parity and clean gillum16."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.ops.camera import rays_for_ids
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    _, culled, k5, _ = kernel_modules()
    times = {}

    def k3(wave, label, o, d, mesh, quirks, live=None):
        feats, _, lvs = _sorted_wave(o, d, mesh, quirks, live=live)
        parity = quirks.reference_triangle_test
        times["culled_nearest", wave] = time_redesigned(
            "culled_nearest", label, feats.shape[0], smi,
            lambda g: culled.culled_nearest_kernel(feats, mesh, lvs,
                                                   quirks=quirks, lanes=g),
            lambda g: f"nearest_kernel<{g}>",
            lambda: culled.culled_nearest_torch(
                feats, mesh.rec, lvs, sign=1.0 if parity else -1.0,
                clip=not parity),
            mesh_work(o, d, mesh, quirks, live=live), None, culled, None,
            None)

    def k4(wave, label, o, d, live):
        feats, t_bound, lvs = _sorted_wave(
            o, d, mesh, CLEAN, live=live,
            t_max=torch.full((o.shape[0],), culled.BIG, device="cuda"))
        times["culled_occluded", wave] = time_redesigned(
            "culled_occluded", label, feats.shape[0], smi,
            lambda g: culled.culled_occluded_kernel(
                feats, t_bound, mesh, lvs, quirks=CLEAN, t_clip=1e-4,
                lanes=g),
            lambda g: f"occluded_kernel<{g}>",
            lambda: culled.culled_occluded_torch(feats, t_bound, mesh.rec,
                                                 lvs, sign=-1.0, t_clip=1e-4),
            occluded_work(o, d, mesh, CLEAN, live=live), None, culled, None,
            None, lambda n: culled.occluded_lanes())

    # parity primary wave: chunk 2 of 65536 ids (rows 204-307), coarse
    scene, _ = dragon_waves(PARITY, torch.arange(1, device="cuda"), 1)
    ids = torch.arange(2 * CHUNK_RAYS, 3 * CHUNK_RAYS, device="cuda")
    o, d = rays_for_ids(scene.camera, RenderConfig(width=640, height=480),
                        0, ids)
    k3("parity primary", f"dragon parity primary chunk ({CHUNK_RAYS} rays, "
       f"coarse)", o, d, scene.clusters, PARITY)
    # clean gillum16 chunk 37 (4096 samples x 16 paths): its primary wave
    # (coarse), its bounce wave (fine) and the bounce wave's shadow rays
    # (fine)
    ids = torch.arange(37 * 4096, 38 * 4096, device="cuda")
    scene, waves = dragon_waves(CLEAN, ids, 16)
    o, d = waves["primary"]
    k3("primary", f"dragon clean gillum16 chunk 37 primary wave "
       f"({o.shape[0]} rays, coarse)", o, d, scene.clusters, CLEAN)
    o1, d1, lv = waves["bounce"]
    mesh = scene.clusters_fine
    k3("bounce", f"dragon clean gillum16 bounce chunk ({o1.shape[0]} rays, "
       f"fine, {lv.mean().item():.3f} live)", o1, d1, mesh, CLEAN, lv)
    for wave, key in (("bounce", "shadow"), ("primary", "primary_shadow")):
        so, sd, slv = waves[key]
        k4(wave, f"dragon clean gillum16 chunk 37 {wave} shadow wave "
           f"({so.shape[0]} rays, fine, {slv.mean().item():.3f} live)", so,
           sd, slv)
    ksc = k5_mesh_scene(device="cuda")
    o, d = rays_for_ids(ksc.camera, RenderConfig(width=256, height=256), 0,
                        torch.arange(CHUNK_RAYS, device="cuda"))
    tr = ksc.triangles
    feats = k5.ray_features(o, d).contiguous()
    rec = k5.pack_triangles(tr.v0, tr.v1, tr.v2, tr.mask)
    times["triangle_nearest", "primary"] = time_redesigned(
        "triangle_nearest", f"700-triangle mesh primary chunk ({CHUNK_RAYS} "
        f"rays)", CHUNK_RAYS, smi,
        lambda g: k5.triangle_nearest_kernel(feats, rec, sign=-1.0,
                                             clip=True, lanes=g),
        lambda g: f"triangle_kernel<{g}>",
        lambda: k5.triangle_nearest_torch(feats, rec, sign=-1.0, clip=True),
        k5_work(CHUNK_RAYS, tr.v0.shape[0]), parent, k5, "triangle_kernel",
        lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)),
        lambda n: k5.launcher_lanes(), k5.LANES)

    parsed = parse_scene(os.path.join(SCENES, "dragon.scn"))
    for label, kw in (("parity depth2 shadows",
                       dict(max_depth=2, use_shadows=True)),
                      ("clean gillum16 depth2 shadows",
                       dict(quirks=CLEAN, monte_carlo=True, num_paths=16,
                            max_depth=2, use_shadows=True))):
        cfg = RenderConfig(width=640, height=480, backend="cuda", **kw)
        scene = parsed.to_scene(cfg.quirks, device="cuda")
        reset_launches()
        render(scene, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        frame_ms = statistics.median(cuda_ms(lambda: render(scene, cfg), 3))
        print(f"[time] dragon 640x480 {label} render end to end on {smi}: "
              f"{frame_ms:.2f} ms (median of 3 warm frames), launches per "
              f"frame {launches}")
    return times


# rows held on the card beyond the TPU files': L2 and L1's folded path at
# full FP32 (bitwise against their plain versions and K3), one group size
LAB_EXTRA_ROWS = {
    "v5_g2_p6": ("lab_v5", dict(group_c=2, passes=6)),
    "v6_g1_p6": ("lab_v6", dict(group_c=1, passes=6)),
}
# bf16x3 rows, folded and unfolded, whose disagreements with K3 are listed
LAB_P3_EXPLAINED = ("v6_g2_p3 (per-plane)", "lab_3pass")
# the row of each lab kernel that stands for it in the kernels' JSON line
LAB_JSON_ROWS = {"lab_v6": ("tools/lab_v5.py:190", "v6_g2_p3 (per-plane)"),
                 "lab_v5": ("tools/lab_v5.py:36", "v5_g2_p3"),
                 "lab_base": ("tools/kernel_lab.py:194", "lab_base"),
                 "lab_probe": ("tools/lab_probe.py:26", "mm_g2_p3"),
                 "lab_flat": ("tools/kernel_lab.py:478", "flat_g2_3p"),
                 "lab_presplit": ("tools/kernel_lab.py:620", "presplit_g2")}
# L5's and L6's rows and the L3 row whose answer each must give bitwise on
# the live rays: the same walk, and at passes 3 the same tensor-core
# fragments
LAB_TWINS = {"flat_g2": "lab_base", "flat_g2_3p": "lab_3pass",
             "flat_g4_3p": "lab_3pass", "presplit_g2": "lab_3pass"}
# the L3 and L5 rows' device ms per launch before the split walk, one block
# walking each tile (this script's final run at commit 7caea27, NVIDIA H100
# 80GB HBM3, 700.00 W: `git show 7caea27:PERF.md`; the other rows' were not
# recorded)
LAB_TILE_WALK_MS = {"lab_base": 1.6576, "lab_3pass": 1.6370,
                    "flat_g2": 1.7534, "flat_g2_3p": 1.8739,
                    "flat_g4_3p": 2.1568}


def lab_split_line(res, smi):
    """`[lab]`'s line for a row of the split walk (L3, L5): the device time
    per call (the sum of its three kernels), beside the same kernel with
    one item per tile, the tile walk's time before the split walk and the
    bound; its items; the rays that differ from the plain version and from
    one item per tile, live and dead."""
    from skele_raytracer_tpu_torch.ops.cuda import lab

    ms = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    before = LAB_TILE_WALK_MS.get(res["name"])
    return (f"[lab] split {res['name']}: {ms(res['dev_ms'])} per call "
            f"(init + walk + unpack, profiler sum; slope {res['ms']:.4f} ms); "
            f"one item per tile {ms(res['tile_dev_ms'])} (slope "
            f"{res['tile_ms']:.4f} ms); one block per tile at 7caea27: "
            f"{ms(before) if before else 'not recorded'}; bound "
            f"{res['bound'][0]:.4f} ms by {res['bound'][1]}; {res['items']} "
            f"items of at most {lab.ITEM_GROUPS} groups, the longest "
            f"{res['longest']} ({int(res['walked'].max())} in the longest "
            f"tile); {res['blocks_per_sm']} blocks/SM x "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} "
            f"SMs; rays differing from the plain version live "
            f"{res['vs_plain'][0]} dead {res['vs_plain'][1]}"
            + ("" if res["passes"] == 6 else " (bf16x3: the tensor cores' "
               "sums round otherwise; class `p3_plain_ok`)")
            + f", from one item per tile live {res['vs_tile'][0]} dead "
            f"{res['vs_tile'][1]}; on {smi}")


def phase_lab(smi):
    """`[lab]`: the kernel lab (ops/cuda/lab.py, csrc/culled_lab.cu) at the
    full dragon bounce batch of skele_raytracer_tpu_torch/tools/
    kernel_lab.py (131,072 rays): every row of the three harnesses
    (kernel_lab, lab_v5, lab_probe) and LAB_EXTRA_ROWS, each kernel against
    its plain version (passes 6 bitwise; passes 3 `kl.p3_plain_ok`: hit
    flags on >= 99.9% of rays, indices on >= 99.9% of the rays where both
    hit and wherever t agrees to 1e-4, t within 1e-5 relative on the same
    triangle; the product stage within 1e-5 of its largest value) and
    against K3 (every full-FP32 row that walks the shortlist must be [OK];
    every bf16x3 one in `kl.p3_fp32_ok`'s class: hit flags on >= 99.9% of
    the rays, t within the bf16x3 bound on the same triangle, every ray on
    another triangle an edge decision inside the bf16x3 band, those rays
    listed for LAB_P3_EXPLAINED), its device time per
    launch (slope of 8 against
    40 launches, and profiler), its plain version's time and its bound
    (`lab_work`); the mm rows with torch.matmul's time; L5's and L6's rows
    against their L3 twins (LAB_TWINS: equal on every live ray; rays that
    differ off the live set are counted); the split walk's rows (L3, L5)
    also with `lab_split_line` (device time per call as the sum of its
    three kernels, beside one item per tile and LAB_TILE_WALK_MS; its
    items), each bitwise equal to the same kernel with one item per tile
    on every ray, live and dead, and its longest item shorter than the
    longest tile's walk; each L5 row against L3 at the same G and one
    block per SM, L5's occupancy (bitwise, timed); the split walk's
    `kl.items_sweep` (1-4 groups per item and one item per tile); the
    cs-sweep (K3 over five clusterings, equal). Returns the JSON entries of L1-L6 without their launches."""
    from skele_raytracer_tpu_torch.ops.cuda import lab
    from skele_raytracer_tpu_torch.tools import kernel_lab as kl
    from skele_raytracer_tpu_torch.tools import lab_probe, lab_v5
    from skele_raytracer_tpu_torch.utils.roofline import lab_work

    t0 = time.perf_counter()
    b, mesh, _ = kl.build_batch(device="cuda")
    print(f"[lab] dragon bounce batch on {smi}: {b.feats.shape[0]} rays "
          f"({float(b.live.mean()):.3f} live), {b.n_tiles} tiles of "
          f"{kl.TILE_R}, {b.n_clusters} clusters of {b.cluster_size}, "
          f"shortlist mean {float(b.counts.float().mean()):.2f} / max "
          f"{int(b.counts.max())} clusters, built in "
          f"{time.perf_counter() - t0:.1f} s")
    ref, line = kl.k3_row(b, mesh, "prod (K3)", True)
    print(f"[lab] {line} on {smi}")
    bound, live = kl.p3_t_bound(b, ref), b.live > 0
    rows = {}
    for harness, table, extra in (
            ("kernel_lab", kl.ROWS, None), ("lab_v5", lab_v5.ROWS, None),
            ("lab_probe", lab_probe.ROWS,
             lambda res, b: lab_probe.print_matmul(res, b, "[lab] ")),
            ("extra", LAB_EXTRA_ROWS, None)):
        for name, (kind, kw) in table.items():
            res = kl.evaluate(b, ref, name, kind, kw, bound=bound)
            res["bound"] = lab_work(b, res["walked"], kind=kind,
                                    passes=res["passes"],
                                    group_c=kw.get("group_c", 2),
                                    stage=res["stage"])
            print(f"[lab] {harness}: {kl.format_row(res)}; bound "
                  f"{res['bound'][0]:.4f} ms by {res['bound'][1]}, "
                  f"{int(res['walked'].sum())} groups walked; on {smi}")
            if extra is not None:
                extra(res, b)
            check(res["plain_ok"], f"[lab] {name}: {kind} disagrees with its "
                  f"plain version")
            if "items" in res:
                print(lab_split_line(res, smi))
                check(res["vs_tile"] == (0, 0), f"[lab] {name}: the split "
                      f"walk differs from one item per tile on "
                      f"{res['vs_tile']} (live, dead) rays")
                check(res["longest"] < int(res["walked"].max()),
                      f"[lab] {name}: the longest item "
                      f"({res['longest']} groups) is no shorter than the "
                      f"longest tile's walk")
            if res["passes"] == 6 and res["stage"] == "loop":
                check(res["vs_k3"] == "OK", f"[lab] {name}: {res['vs_k3']} "
                      f"against K3")
            if "k3_ok" in res:
                check(res["k3_ok"], f"[lab] {name}: bf16x3 outside its class "
                      f"against K3: {res['k3_class']}")
            if name in LAB_P3_EXPLAINED:
                for text in ([kl.worst_pair(b, res["out"], ref, live)]
                             + kl.flip_lines(b, res["out"], ref, live)):
                    print(f"[lab]   {name} vs K3: {text}")
            rows[name] = res
    for name, twin in LAB_TWINS.items():
        (t, i), (rt, ri) = rows[name]["out"], rows[twin]["out"]
        differ = (t != rt) | (i != ri)
        n_live, n_all = int((differ & live).sum()), int(differ.sum())
        print(f"[lab] {name} against {twin}: {n_live} live rays differ, "
              f"{n_all} of all rays"
              + (" (dead rays only: the walk reached clusters past the live "
                 "rays' shortlist)" if n_all > n_live == 0 else ""))
        check(n_live == 0, f"[lab] {name} differs from {twin} on {n_live} "
              f"live rays")
    # L5 against L3 at L5's occupancy (one block per SM), at L5's G
    ms = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    for name, twin in LAB_TWINS.items():
        if rows[name]["kind"] != "lab_flat":
            continue
        kind, kw = kl.ROWS[twin]
        kw = dict(kw, group_c=rows[name]["kw"]["group_c"])
        fn = lambda: lab.lab_nearest_kernel(kind, b, sm_blocks=1, **kw)
        d = kl.differ(fn(), rows[name]["out"], b.live)
        one = kl.profiler_ms(fn, kl.kernel_tag(kind, kw))
        fits = lab.blocks_per_sm(kind, kw["group_c"], kw.get("passes", 6),
                                 b.cluster_size)
        print(f"[lab] occupancy: {name} (L5, {rows[name]['blocks_per_sm']} "
              f"block/SM) {ms(rows[name]['dev_ms'])} against L3 at G "
              f"{kw['group_c']} and 1 block/SM {ms(one)} (L3 holds {fits}); "
              f"rays differing live {d[0]} dead {d[1]}; on {smi}")
        check(d == (0, 0), f"[lab] {name} differs from L3 at one block per "
              f"SM on {d} (live, dead) rays")
    kl.items_sweep(b, emit=lambda text: print(f"[lab] items-sweep {text} on "
                                              f"{smi}"))
    same = kl.cs_sweep("cuda",
                       emit=lambda text: print(f"[lab] {text} on {smi}"))
    check(same, "[lab] K3 disagrees across clusterings")
    print(f"[lab] the lab phase took {time.perf_counter() - t0:.1f} s wall "
          f"on {smi}")
    out = {}
    for kind, (tpu, name) in LAB_JSON_ROWS.items():
        res = rows[name]
        mine = [r for r in rows.values() if r["kind"] == kind]
        lib = res.get("library_ms")
        out[kind] = dict(
            name=kind, route="cuda",
            source="skele_raytracer_tpu_torch/csrc/culled_lab.cu",
            replaces=tpu, max_abs_err=max(r["plain_err"] for r in mine),
            ms=res["dev_ms"] if res["dev_ms"] is not None else res["ms"],
            plain_ms=res["plain_ms"], bound_ms=res["bound"][0],
            bound_by=res["bound"][1],
            library_ms=None if lib is None else lib["float32"])
    return out


def phase_median(smi):
    """`[median]`: skele_raytracer_tpu_torch/tools/lab_median.py on the
    card: the lab batch on Morton runs and on the recursive object median,
    each clustering's shortlist summary and K3's time on it; K3's answers,
    unsorted, must be bitwise equal."""
    from skele_raytracer_tpu_torch.tools import lab_median

    t0 = time.perf_counter()
    res = lab_median.run("cuda", emit=lambda text: print(
        f"[median] {text} on {smi}"))
    check(res["same"], f"[median] K3's answers differ between the "
          f"clusterings: {res['median']['vs']}")
    print(f"[median] the phase took {time.perf_counter() - t0:.1f} s wall")
    return res


FD_SPEC = dict(width=96, height=54, paths=4, depth=2, chunk=4096,
               scene=os.path.join(SCENES, "spheres1.scn"), seed=7)
FD_TARGET = 1e-3


def phase_fd():
    """`[fd]`: the fixed-topology check (skele_raytracer_tpu_torch/tools/
    fixed_topology_fd.py) at bench.py's 96x54 spheres1 frame (clean,
    gillum 4, depth 2, shadows, chunk 4,096, seed 7): K1's records and
    K2's gradient in the sphere centres on the card, written to an npz and
    checked by the tool's entry point in float64 on the card; then the
    figure with the plain versions' records (bitwise K1's) and gradient on
    the card; K2's gradient against autograd of the float64 replay (the
    exact gradient the differences approximate); and the samples whose
    records the plain version on the CPU takes otherwise. The figure must
    stay within FD_TARGET."""
    from skele_raytracer_tpu_torch.config import CLEAN
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt
    from skele_raytracer_tpu_torch.scene.parser import parse_scene
    from skele_raytracer_tpu_torch.tools import fixed_topology_fd as ft

    t0 = time.perf_counter()
    spec, seed = json.dumps(FD_SPEC), FD_SPEC["seed"]
    scene = parse_scene(FD_SPEC["scene"]).to_scene(CLEAN, device="cuda")
    before = dict(pt.LAUNCHES)
    rec, ga = ft.records_and_grad(scene, ft.config(FD_SPEC, "cuda"), seed)
    torch.cuda.synchronize()
    for name in ("pathtrace_records", "pathtrace_bwd"):
        check(pt.LAUNCHES[name] > before[name], f"[fd] {name} not launched")
    os.makedirs(SCRATCH, exist_ok=True)
    npz = os.path.join(SCRATCH, "fixed_topology.npz")
    np.savez(npz, rec=rec.cpu().numpy(), ga=ga.cpu().numpy())
    t1 = time.perf_counter()
    fig = ft.check(npz, spec, "cuda")
    t2 = time.perf_counter()
    rec_p, ga_p = ft.records_and_grad(scene, ft.config(FD_SPEC, "cuda"),
                                      seed, plain=True)
    check(torch.equal(rec_p, rec), "[fd] K1's records differ from the "
          "plain version's")
    np.savez(npz, rec=rec_p.cpu().numpy(), ga=ga_p.cpu().numpy())
    plain = ft.check(npz, spec, "cuda")
    # K2 against the exact gradient of the float64 replay: its own error,
    # without the differences' O(eps^2) truncation
    exact = ft.autograd_centres(scene, ft.config(FD_SPEC, "cuda"), seed, rec)
    mask = scene.spheres.mask.cpu().numpy() > 0
    k2_exact = ft.figure(ga.cpu().numpy(), exact, mask, 0.0)
    # the plain versions on the CPU round transcendentals otherwise
    rec_c, _ = ft.records_and_grad(parse_scene(FD_SPEC["scene"]).to_scene(
        CLEAN), ft.config(FD_SPEC, "cpu"), seed)
    flips = (rec_c != rec.cpu()).any(0)
    print(f"[fd] spheres1 96x54 clean gillum4 depth2 shadows: "
          f"geometry_fixed_topology_fd_rel {fig['geometry_fixed_topology_fd_rel']!r}"
          f" (ga from K2), max_abs_err {fig['max_abs_err']!r}, "
          f"{fig['n_params']} parameters, eps {fig['fd_eps']}; with ga from "
          f"the plain backward {plain['geometry_fixed_topology_fd_rel']!r} "
          f"(max_abs_err {plain['max_abs_err']!r}); max |K2 - plain| "
          f"{float((ga - ga_p).abs().max())!r}; K2 against autograd of the "
          f"float64 replay {k2_exact['geometry_fixed_topology_fd_rel']!r} "
          f"(max_abs_err {k2_exact['max_abs_err']!r}); the CPU's plain records "
          f"differ from K1's in {int(flips.sum())} of {flips.numel()} "
          f"samples; records and K2 "
          f"{t1 - t0:.2f} s, the float64 differences on the card "
          f"{t2 - t1:.2f} s, the phase {time.perf_counter() - t0:.1f} s wall")
    check(fig["geometry_fixed_topology_fd_rel"] <= FD_TARGET,
          f"[fd] the fixed-topology figure {fig} is over {FD_TARGET}")
    return fig


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


TRAIN_STEPS, TRAIN_LR = 3, 5e-3
# The target's render seed. A fit renders step i with seed i; a target
# rendered with seed 0 would share step 0's samples, whose noise then
# cancels in the first loss only.
TARGET_SEED = 1000003


def phase_train_headline(smi, parent=None):
    """`train.fit` for TRAIN_STEPS steps at the 1080p headline, parity and
    clean, all leaves trainable, with the launch counters set to 0 just
    before and read just after each fit; then each part's time, K2 at each
    lane count (`time_k2`) and a profiled `train_step`, with `parent` also
    the step through the parent tree's K1 in turns with this tree's.
    Returns the parity run's numbers."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.models.renderer import render_radiance
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    out = {}
    for mode, quirks in (("parity", PARITY), ("clean", CLEAN)):
        scene, cfg = headline(quirks)
        with torch.no_grad():
            target = render_radiance(scene, cfg, TARGET_SEED)
        start = perturbed(scene)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        _, losses = train.fit(start, cfg, target, steps=TRAIN_STEPS,
                              learning_rate=TRAIN_LR, log_every=0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)) and all(
            b < a for a, b in zip(losses, losses[1:])),
              f"{mode}: losses not finite and decreasing: {losses}")
        want = dict.fromkeys(launches, 0)
        want.update(pathtrace_records=TRAIN_STEPS, pathtrace_bwd=TRAIN_STEPS)
        check(launches == want, f"{mode}: launches {launches}, want {want}")
        route = "records" if pt._can_replay(start, cfg) else "wavefront"
        check(route == "records", f"{mode}: gradient route {route}")
        print(f"[train] spheres2 1920x1080 {mode} gillum16 depth2 shadows, "
              f"all leaves trainable, lr {TRAIN_LR}, gradient route "
              f"'{route}' (K1 with records, then K2): losses "
              f"{', '.join(f'{x:.6e}' for x in losses)}; fit of "
              f"{TRAIN_STEPS} steps {fit_s:.3f} s wall; launches {launches}; "
              f"peak memory {peak / 2**20:.1f} MiB (ok)")

        state = train.init_state(start, TRAIN_LR)
        n = cfg.width * cfg.height * cfg.samples_per_pixel

        def fwd_bwd():
            state.optimizer.zero_grad(set_to_none=True)
            train.full_loss(state.scene, cfg, 0, target).backward()

        with torch.no_grad():
            fwd_ms = median_ms(lambda: render_radiance(start, cfg, 0), 3)
        step_ms = median_ms(fwd_bwd, 3)
        tabs = pt._pack_tables(start)
        planes = pt._plane_inputs(cfg, torch.arange(n, device="cuda"))
        static = pt._static_kernel_args(start, cfg)
        *_, rec = pt.pathtrace_forward(tabs, planes, 0, static, records=True)
        g = torch.randn(n, 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
        k1_ms = median_ms(lambda: pt.pathtrace_forward(tabs, planes, 0,
                                                       static), 5)
        k1r_ms = median_ms(lambda: pt.pathtrace_forward(
            tabs, planes, 0, static, records=True), 5)
        k2_ms = median_ms(lambda: pt.pathtrace_backward(
            tabs, planes, rec, g, 0, static), 5)
        print(f"[train] {mode} times on {smi}: render_radiance (forward) "
              f"{fwd_ms:.4f} ms, full_loss forward + backward {step_ms:.4f} "
              f"ms (median of 3 warm); K1 forward-only {k1_ms:.4f} ms, K1 "
              f"with records {k1r_ms:.4f} ms, K2 {k2_ms:.4f} ms (median of "
              f"5); records {rec.numel() * 4 / 1e6:.1f} MB ({rec.shape[0]} x "
              f"{n} int32)")
        out[mode] = dict(k1r_ms=k1r_ms, k2_ms=k2_ms, k1_ms=k1_ms,
                         launches=launches, static=static, n=n)
        time_k2(f"spheres2 1920x1080 {mode} gillum16", tabs, planes, rec, g,
                static)
        profile_train_step(state, cfg, target, mode, smi, parent)
        out[mode]["k2_err"], out[mode]["k2_plain_ms"] = check_k2_frame(
            f"{mode} 1920x1080", tabs, planes, rec, g, static, smi)
        if mode == "parity":
            plain_r = lambda: pt.frame_math_torch(tabs, planes, 0,
                                                  emit_records=True, **static)
            out[mode]["k1r_plain_ms"] = median_ms(plain_r, 1)
            print(f"[train] parity plain K1 with records on {smi}: "
                  f"{out[mode]['k1r_plain_ms']:.2f} ms")
    return out


def time_k2(label, tabs, planes, rec, g, static):
    """K2 over the whole frame by CUDA events around one wrapper call, at
    each lane count of pt.BWD_LANES (`[tune]`, median of 5), beside its
    bound (`k2_work`)."""
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    n = planes[0].shape[0]
    b_ms, b_by = k2_work(static, n)
    run = lambda lanes=None: pt.pathtrace_backward(tabs, planes, rec, g, 0,
                                                   static, lanes=lanes)
    tune = {lanes: median_ms(lambda lanes=lanes: run(lanes), 5)
            for lanes in pt.BWD_LANES}
    print(f"[tune] pathtrace_bwd {label}: ms per call at lanes per sample "
          + ", ".join(f"{k}: {v:.4f}" for k, v in tune.items())
          + f" (the launcher picks {k2_launcher_lanes(static, n)}); bound "
          f"{b_ms:.4f} ms by {b_by}")


def phase_k2_lights():
    """K2 at the most lights it takes, with shadows (22, the record bits)
    and without (32, its shared memory: pathtrace.MAX_REPLAY_LIGHTS), the
    last two KERNEL_CASES (checked there against the plain version) at
    1920x1080 clean gillum16: `time_k2`."""
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    for name, scene_name, overrides in KERNEL_CASES[-2:]:
        scene, cfg = case_scene_and_config(
            scene_name, dict(overrides, num_paths=16), 1920, 1080, "cuda")
        check(pt._can_replay(scene, cfg), f"{name}: no records route")
        n = cfg.width * cfg.height * cfg.samples_per_pixel
        tabs = pt._pack_tables(scene)
        planes = pt._plane_inputs(cfg, torch.arange(n, device="cuda"))
        static = pt._static_kernel_args(scene, cfg)
        *_, rec = pt.pathtrace_forward(tabs, planes, 0, static, records=True)
        g = torch.randn(n, 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
        shadows = "shadows" if cfg.use_shadows else "no shadows"
        time_k2(f"spheres2 with {static['L'] + static['LD']} lights "
                f"1920x1080 clean gillum16 {shadows}", tabs, planes, rec, g,
                static)


def check_k2_frame(label, tabs, planes, rec, g, static, smi,
                   chunk=1 << 16):
    """K2 over the whole frame, as the main path launches it (one resident
    wave of blocks, sized from the card's SM count and K2's occupancy,
    each striding over the samples, then a reduce over the blocks' partial
    tables; so the order of its sums, and its bits, depend on the card as
    well as the inputs), against the plain version's table gradients
    summed over chunks of `chunk` ids, per table within GRAD_RTOL
    max|plain| + GRAD_ATOL; two K2 runs bitwise equal. Returns (worst
    |diff|, the plain version's ms)."""
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    n = planes[0].shape[0]
    k2 = pt.pathtrace_backward(tabs, planes, rec, g, 0, static)
    again = pt.pathtrace_backward(tabs, planes, rec, g, 0, static)
    check(all(torch.equal(a, b) for a, b in zip(k2, again)),
          f"{label}: K2 differs between runs")
    plain = [torch.zeros_like(t) for t in k2]

    def plain_k2():
        for i in range(0, n, chunk):
            sl = slice(i, i + chunk)
            for acc, d in zip(plain, pt.replay_table_grads(
                    tabs, tuple(p[sl] for p in planes), rec[:, sl], g[sl], 0,
                    static)):
                acc += d

    plain_ms = cuda_ms(plain_k2, 1)[0]
    worst, rel = 0.0, 0.0
    for name, a, w in zip(("sph", "tri", "misc", "pl", "dl"), k2, plain):
        err = (a - w).abs().max().item()
        scale = w.abs().max().item()
        check(err <= GRAD_RTOL * scale + GRAD_ATOL,
              f"{label}: K2 {name} off by {err:.3e} (max |plain| {scale:.3e})")
        worst = max(worst, err)
        rel = max(rel, err / max(scale, 1e-30))
    print(f"[kernel-vs-plain] K2 whole frame, {label} ({n} samples, "
          f"random cotangent) vs autograd of the plain replay summed over "
          f"{-(-n // chunk)} chunks of {chunk} ids: worst |diff| {worst:.3e}, "
          f"worst |diff|/max|plain| {rel:.3e}, two runs bitwise equal (ok); "
          f"plain version {plain_ms:.2f} ms on {smi}")
    return worst, plain_ms


def profile_device(label, fn, wall, smi, tags):
    """One `fn()` under torch.profiler: the device's busy time (self CUDA
    time of every kernel), the time and share of it in the kernels whose
    names hold each of `tags` ({name: substring}), the device kernels
    launched, and the idle share of `wall`, the unprofiled call's time in
    ms (`device_events`). A trace that misses a tagged kernel is taken
    again, up to `PROFILE_TRIES` times; then the line says
    the breakdown was not measured (the launch counters, not the profiler,
    show which kernels the path ran)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        events = device_events(fn, fn)
        busy = sum(dev_us(e) for e in events) / 1e3
        part = {name: sum(dev_us(e) for e in events if tag in e.key) / 1e3
                for name, tag in tags.items()}
        if busy > 0 and all(v > 0 for v in part.values()):
            break
    else:
        print(f"[profile] {label} on {smi}: not measured: {PROFILE_TRIES} "
              f"traces showed no device time for some of {part}")
        return
    print(f"[profile] {label} on {smi}: {wall:.3f} ms (unprofiled, median "
          f"of 3), device busy {busy:.3f} ms -> idle "
          f"{max(0.0, 1 - busy / wall):.1%}; "
          + ", ".join(f"{name} {v:.3f} ms ({v / busy:.1%})"
                      for name, v in part.items())
          + f"; {sum(e.count for e in events)} device kernels"
          + (f" (trace {attempt} of {PROFILE_TRIES})" if attempt > 1 else ""))


def profile_train_step(state, cfg, target, label, smi, parent=None):
    """One `train_step` under the profiler (`profile_device`): K1's, K2's
    and its reduce's shares, and the idle share of the unprofiled step's
    wall time (median of 3). With `parent`, the step's wall time through
    this tree's and the parent tree's K1 (with records) in turns."""
    from skele_raytracer_tpu_torch.models import train

    def step():
        train.train_step(state, cfg, 0, target)
        torch.cuda.synchronize()

    step()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    profile_device(f"{label} train_step", step, statistics.median(walls), smi,
                   {"K1 with records": "pathtrace_kernel",
                    "K2": "pathtrace_bwd_kernel",
                    "K2's reduce": "reduce_kernel"})
    if parent is not None:
        from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

        ms = turns_ms([step, lambda: parent.call(pt, step)], reps=6)
        print(f"[profile] {label} train_step on {smi}: {ms[0]:.3f} ms with "
              f"this tree's K1, {ms[1]:.3f} ms with the parent tree's (CUDA "
              f"events, median of 6 each, in turns)")


def phase_train_routes():
    """A 64x36 fit on the card against the same fit on the CPU plain path,
    and the 128-sphere scene's gradient, which takes the wavefront."""
    from skele_raytracer_tpu_torch.config import PARITY, RenderConfig
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.models.renderer import render_radiance
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt

    losses = {}
    target = None
    for dev in ("cuda", "cpu"):
        scene, cfg = headline(PARITY, dev, 64, 36)
        if target is None:
            with torch.no_grad():
                target = render_radiance(scene, cfg, TARGET_SEED).cpu()
        _, losses[dev] = train.fit(perturbed(scene), cfg, target,
                                   steps=TRAIN_STEPS,
                                   learning_rate=TRAIN_LR, log_every=0)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                 losses["cpu"]))
    print(f"[train] 64x36 spheres2 parity gillum16 fit of {TRAIN_STEPS} "
          f"steps: card {losses['cuda']}, CPU plain path {losses['cpu']}, "
          f"worst relative difference {rel:.3e} "
          f"({'ok' if rel <= 1e-4 else 'FAIL'})")
    check(rel <= 1e-4, "card and CPU fits disagree")

    scene = many_sphere_scene(128, device="cuda")
    cfg = RenderConfig(width=64, height=36, monte_carlo=True, num_paths=2,
                       max_depth=2, use_shadows=True, quirks=PARITY,
                       backend="cuda")
    route = "records" if pt._can_replay(scene, cfg) else "wavefront"
    check(route == "wavefront", f"128 spheres took the {route} route")
    state = train.init_state(scene)
    reset_launches()
    train.full_loss(state.scene, cfg, 0, torch.zeros(36, 64, 3,
                                                     device="cuda")).backward()
    torch.cuda.synchronize()
    launches = read_launches()
    grads = [t.grad for t in state.scene.spheres.tensors()
             if t.grad is not None]
    check(launches["pathtrace"] == 1 and launches["pathtrace_bwd"] == 0
          and launches["pathtrace_records"] == 0,
          f"128-sphere gradient launches {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in grads)
          and any(float(g.abs().max()) > 0 for g in grads),
          "128-sphere gradient is not finite and nonzero")
    print(f"[train] 128-sphere scene 64x36 gillum2: gradient route "
          f"'{route}' (forward K1, backward through the wavefront under "
          f"autograd); launches {launches} (ok)")


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


def phase_grad_mesh():
    """A gradient of the (lit) dragon through K3/K4 with the triangle
    vertices trainable, against the CPU plain path on the same sampled
    ids; then one fit step that must refresh the clusters and the normal
    table."""
    import dataclasses

    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.models.renderer import (
        render_ids_chunked,
        render_radiance,
    )
    from skele_raytracer_tpu_torch.ops.geometry import cross, normalize

    w, h = 160, 120
    n_ids = 256
    ids = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        w * h, n_ids, replace=False)))
    names = ("v0", "v1", "v2")
    grads, launches = {}, None
    for dev in ("cuda", "cpu"):
        cfg = RenderConfig(width=w, height=h, quirks=CLEAN, monte_carlo=True,
                           num_paths=4, max_depth=2, use_shadows=True,
                           backend="cuda" if dev == "cuda" else "torch")
        scene = lit_dragon(dev)
        tris = dataclasses.replace(scene.triangles, **{
            k: getattr(scene.triangles, k).clone().requires_grad_(True)
            for k in names})
        scene = dataclasses.replace(scene, triangles=tris)
        if dev == "cuda":
            reset_launches()
        r = render_ids_chunked(scene, cfg, 0, ids.to(dev))
        (r * r).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
        grads[dev] = [getattr(tris, k).grad.cpu() for k in names]
    check(launches["culled_nearest"] > 0 and launches["culled_occluded"] > 0
          and launches["pathtrace"] == 0,
          f"the dragon gradient did not run K3 and K4: {launches}")
    worst = 0.0
    for k, a, b in zip(names, grads["cuda"], grads["cpu"]):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        check(scale > 0, f"dragon {k} gradient is zero")
        check(err <= GRAD_RTOL * scale + GRAD_ATOL,
              f"dragon {k} gradient off by {err:.3e} (max {scale:.3e})")
        worst = max(worst, err / scale)
    print(f"[grad] dragon (light from above) {w}x{h} clean gillum4 depth2 "
          f"shadows, {n_ids} sampled ids, triangles.v0/v1/v2 trainable: card "
          f"vs CPU plain path, worst "
          f"|diff|/max {worst:.3e}, nonzero; launches {launches} (ok)")

    cfg = RenderConfig(width=w, height=h, quirks=CLEAN, monte_carlo=True,
                       num_paths=4, max_depth=2, use_shadows=True,
                       backend="cuda")
    scene = lit_dragon("cuda")
    with torch.no_grad():
        target = render_radiance(scene, cfg, TARGET_SEED)
    start = dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, v0=scene.triangles.v0 + 0.01))
    fitted, losses = train.fit(start, cfg, target, steps=1,
                               learning_rate=1e-3, log_every=0,
                               trainable_paths=("triangles",))
    tr = fitted.triangles
    perm = fitted.clusters.perm.long()
    real = fitted.clusters.mask > 0
    check(float((tr.v0 - start.triangles.v0).abs().max()) > 0,
          "the fit step did not move the vertices")
    check(torch.equal(fitted.clusters.v0[real], tr.v0[perm[real]]),
          "clusters not refreshed after the step")
    check(torch.equal(fitted.tri_normals,
                      normalize(cross(tr.v1 - tr.v0, tr.v2 - tr.v0))),
          "normal table not refreshed after the step")
    print(f"[grad] dragon fit step (triangles trainable): loss "
          f"{losses[0]:.6e}; clusters and normal table rebuilt from the "
          f"moved vertices (ok)")


# ---------------------------------------------------------------------------
# [fused]: the nearest-sphere kernel K6 and the fused kernel K7


def fused_mesh_scene(t=700, seed=12, device="cuda"):
    """tests/conftest.py make_mesh_scene's scene, from the same draws (this
    script imports no test module): k5_mesh_scene's triangles, sphere and
    point light, clustered 64 triangles at a time so that the mesh has
    more than 4 clusters and takes the fused route."""
    import dataclasses

    from skele_raytracer_tpu_torch.ops import accel

    scene = k5_mesh_scene(t, seed, device)
    tr = scene.triangles
    return dataclasses.replace(scene, clusters=accel.build_clusters(
        tr.v0, tr.v1, tr.v2, tr.mask, cluster_size=64))


def parsed_scene(name, quirks, device="cuda"):
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    return parse_scene(os.path.join(SCENES, name)).to_scene(quirks,
                                                             device=device)


def phase_k6(smi):
    """K6 against its plain version on the card, bitwise: 65,536 random
    rays x 24 spheres (2 rows masked), parity and clean clip, and
    test.scn's sphere table; then its time at 65,536 rays x spheres2's
    table. Returns its numbers."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
    from skele_raytracer_tpu_torch.ops.camera import rays_for_ids
    from skele_raytracer_tpu_torch.ops.cuda import intersect as ik

    rng = np.random.default_rng(11)
    o = torch.from_numpy(rng.uniform(-10, 10, (CHUNK_RAYS, 3)).astype(
        np.float32)).cuda()
    d = torch.from_numpy(rng.normal(size=(CHUNK_RAYS, 3)).astype(
        np.float32)).cuda()
    c = torch.from_numpy(rng.uniform(-8, 8, (24, 3)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.5, 3.0, 24).astype(np.float32))
    m = torch.ones(24)
    m[-2:] = 0.0
    test_sph = parsed_scene("test.scn", CLEAN).spheres
    cases = [("random 24 spheres", PARITY, c.cuda(), r.cuda(), m.cuda()),
             ("random 24 spheres", CLEAN, c.cuda(), r.cuda(), m.cuda()),
             ("test.scn's spheres", CLEAN, test_sph.center, test_sph.radius,
              test_sph.mask)]
    for label, q, cen, rad, msk in cases:
        got = launched(ik, "sphere_nearest", lambda: ik.sphere_nearest(
            o, d, cen, rad, msk, quirks=q))
        t_clip = 1.0 if q.near_clip_t_le_1 else 1e-4
        pt, pi = ik.sphere_nearest_torch(o, d, ik.sphere_rows(cen, rad, msk),
                                         t_clip)
        hit = pt < ik.BIG
        want = (torch.where(hit, pt, float("inf")), pi.long(), hit)
        for a, b, name in zip(got, want, ("t", "index", "hit")):
            check(torch.equal(a, b), f"K6 {label}: {name} differs on "
                  f"{(a != b).sum().item()} rays")
        print(f"[fused] K6 {label} (t_clip {t_clip:g}): {CHUNK_RAYS} rays x "
              f"{cen.shape[0]} rows, {hit.float().mean().item():.3f} hit; t, "
              f"index and hit bitwise equal to the plain version (ok)")

    scene = parsed_scene("spheres2.scn", PARITY)
    cfg = RenderConfig(width=1920, height=1080)
    start = 540 * 1920
    o, d = rays_for_ids(scene.camera, cfg, 0, torch.arange(
        start, start + CHUNK_RAYS, device="cuda"))
    o, d = o.contiguous(), d.contiguous()
    sph = scene.spheres
    rows = ik.sphere_rows(sph.center, sph.radius, sph.mask)
    ms = median_ms(lambda: ik.sphere_nearest_kernel(o, d, rows, 1.0), 20)
    plain_ms = median_ms(lambda: ik.sphere_nearest_torch(o, d, rows, 1.0), 3)
    kt, ki = ik.sphere_nearest_kernel(o, d, rows, 1.0)
    pt, pi = ik.sphere_nearest_torch(o, d, rows, 1.0)
    check(torch.equal(kt, pt) and torch.equal(ki, pi),
          "K6 differs on spheres2's table")
    n_real = int((sph.mask > 0).sum())
    bound = k6_work(CHUNK_RAYS, rows.shape[0])
    print(f"[time] sphere_nearest spheres2 1080p primary chunk ({CHUNK_RAYS} "
          f"rays from row 540 x {rows.shape[0]} rows, {n_real} spheres) on "
          f"{smi}: kernel {ms:.4f} ms, plain PyTorch {plain_ms:.3f} ms "
          f"(median of 20 and 3 warm runs); bound {bound[0]:.4f} ms by "
          f"{bound[1]}")
    return dict(ms=ms, plain_ms=plain_ms, bound=bound, err=0.0)


FUSED_DIRECT_RTOL = 1e-5  # K7 vs plain: |direct diff| <= this x max|plain|
# Adam's rate of the fused fit of lit dragon's vertices. At 1e-3 (and 1e-4)
# each step moves every sub-millimetre triangle's vertices by about the rate
# and the loss rises, in the JAX package's jnp fit too
# (tests/test_torch_fused_fit.py); at 3e-5 it falls on the CPU at 160x120.
FUSED_FIT_LR = 3e-5


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


def phase_fused_kernels():
    """K7 against its plain version on five waves: a 700-triangle synthetic
    mesh (one sphere, one point light), lit dragon's primary and bounce
    waves, test.scn's primary and bounce waves. Returns the worst
    differences."""
    from skele_raytracer_tpu_torch.config import CLEAN

    worst = [0.0, 0.0]

    def run(label, scene, o, d, live=None):
        errs = check_fused(label, o.contiguous(), d.contiguous(), scene, live)
        worst[:] = [max(a, b) for a, b in zip(worst, errs)]

    o, d, _, _ = random_rays(CHUNK_RAYS, 17, "cuda")
    run("synthetic 700 tris + sphere + point light", fused_mesh_scene(),
        o * (10 / 12), d)
    ids = torch.arange(37 * 4096, 38 * 4096, device="cuda")
    scene, waves = dragon_waves(CLEAN, ids, 16, scene=lit_dragon("cuda"))
    run("lit dragon primary (chunk 37)", scene, *waves["primary"])
    run("lit dragon bounce (chunk 37, gillum 16)", scene, *waves["bounce"])
    scene = parsed_scene("test.scn", CLEAN)
    ids = torch.arange(300 * 1024, 300 * 1024 + 4096, device="cuda")
    waves = mesh_waves(scene, CLEAN, 1024, 768, ids, 4)
    run("test.scn 1024x768 primary (rows 300-303)", scene, *waves["primary"])
    run("test.scn 1024x768 bounce (gillum 4)", scene, *waves["bounce"])
    return worst


def phase_lanes_vs_plain():
    """K3, K4 and K7 against their plain versions on the card for each lane
    count they are built for (culled.LANES) and for the launcher's own
    choice: on dragon's chunk-37 primary wave (4,096 rays; K7 on lit
    dragon, shadows on) and on its bounce wave cut to 65,536 - 37 rays, a
    count that is no multiple of any tile, with the wave's dead rays
    sorted to the tail; K4 on the shadow waves from both (unbounded and
    with bounds). K3's t and index bitwise equal, K4's occlusion equal; K7
    as `fused_diff`. Returns K7's worst (|direct diff|, |t diff|)."""
    from skele_raytracer_tpu_torch.config import CLEAN

    _, culled, _, mk = kernel_modules()
    ids = torch.arange(37 * 4096, 38 * 4096, device="cuda")
    cut = CHUNK_RAYS - 37
    worst7 = [0.0, 0.0]
    scene, waves = dragon_waves(CLEAN, ids, 16)
    o1, d1, lv = (x[:cut] for x in waves["bounce"])
    for label, (o, d, live), mesh in (
            ("primary", (*waves["primary"], None), scene.clusters),
            ("bounce", (o1, d1, lv), scene.clusters_fine)):
        feats, _, lvs = _sorted_wave(o, d, mesh, CLEAN, live=live)
        pt, pi = culled.culled_nearest_torch(feats, mesh.rec, lvs, sign=-1.0,
                                             clip=True)
        for g in (None, *culled.LANES):
            kt, ki = launched(culled, "culled_nearest",
                              lambda: culled.culled_nearest_kernel(
                                  feats, mesh, lvs, quirks=CLEAN, lanes=g))
            check(torch.equal(kt, pt) and torch.equal(ki, pi),
                  f"K3 {label} lanes {g}: differs on "
                  f"{((kt != pt) | (ki != pi)).sum().item()} rays")
        print(f"[kernel-vs-plain] K3 dragon clean chunk 37 {label} wave "
              f"({feats.shape[0]} rays, {mesh.cluster_size}-triangle "
              f"clusters), lanes per ray {culled.LANES} and the launcher's "
              f"{culled.lanes_for(feats.shape[0])}: t and index bitwise "
              f"equal (ok)")
    mesh = scene.clusters_fine
    for label, key in (("primary shadow", "primary_shadow"),
                       ("bounce shadow", "shadow")):
        o, d, live = (x[:cut] for x in waves[key])
        n = o.shape[0]
        bounds = (torch.full((n,), culled.BIG, device="cuda"),
                  torch.linspace(0.01, 0.3, n, device="cuda"))
        for tmax in bounds:
            feats, bound, lvs = _sorted_wave(o, d, mesh, CLEAN, live=live,
                                             t_max=tmax)
            want = culled.culled_occluded_torch(feats, bound, mesh.rec, lvs,
                                                sign=-1.0, t_clip=1e-4)
            for g in (None, *culled.LANES):
                got = launched(culled, "culled_occluded",
                               lambda: culled.culled_occluded_kernel(
                                   feats, bound, mesh, lvs, quirks=CLEAN,
                                   t_clip=1e-4, lanes=g))
                check(torch.equal(got, want),
                      f"K4 {label} lanes {g}: differs on "
                      f"{(got != want).sum().item()} rays")
        print(f"[kernel-vs-plain] K4 dragon clean chunk 37 {label} wave ({n} "
              f"rays, {live.mean().item():.3f} live, dead rays sorted last, "
              f"{mesh.cluster_size}-triangle clusters), unbounded and "
              f"bounded, lanes per ray {culled.LANES} and the launcher's "
              f"{culled.occluded_lanes()}: occlusion equal (ok)")
    lit = lit_dragon("cuda")
    _, waves = dragon_waves(CLEAN, ids, 16, scene=lit)
    tabs = mk.pack_tables(lit)
    o1, d1, lv = (x[:cut] for x in waves["bounce"])
    for label, (o, d, live) in (("primary", (*waves["primary"], None)),
                                ("bounce", (o1, d1, lv))):
        order, lvs = mk.sort_rays(o, d, lit.clusters, live)
        feats = culled._ray_features10(o, d)[order].contiguous()
        p = mk.fused_shade_torch(feats, lvs, lit.clusters.rec, *tabs,
                                 use_shadows=True)
        for g in (None, *culled.LANES):
            k = launched(mk, "fused_shade", lambda: mk.fused_shade_kernel(
                feats, lvs, lit.clusters, *tabs, use_shadows=True, lanes=g))
            errs = fused_diff(f"lit dragon {label} lanes {g}", k, p)
            worst7 = [max(a, b) for a, b in zip(worst7, errs)]
        hit = p[2] > 0
        print(f"[kernel-vs-plain] K7 lit dragon chunk 37 {label} wave "
              f"({feats.shape[0]} rays, shadows, "
              f"{p[4][hit].mean().item():.3f} of hits unshadowed), lanes "
              f"per ray {culled.LANES} and the launcher's "
              f"{culled.lanes_for(feats.shape[0])}: kind, index, shadow bits "
              f"equal, max |t diff| {worst7[1]:.3e}, max |direct diff| "
              f"{worst7[0]:.3e} (ok)")
    return worst7


FUSED_FRAMES = [  # (label, scene, width, height, paths, warm frames
    ("dragon", "dragon.scn", 640, 480, 16, 3),  # timed; 0: the first)
    ("test.scn", "test.scn", 1024, 768, 4, 0),  # clean, depth 2, shadows
]


def phase_fused_main(smi, parent=None):
    """The fused route's main path: `render` of dragon 640x480 clean
    gillum 16 depth 2 shadows with fused_megakernel, the launch counters
    set to 0 just before and read just after (K7 150 times, no other
    kernel), its time beside the split route's frame (median of 3 warm
    frames each) and a device profile of one chunk through each route,
    fused against split (>= 99% of
    values within rtol 1e-3, atol 1e-3: tests/test_megakernel.py's
    criterion); the same for test.scn 1024x768 clean gillum 4 (timed on
    the first frame of each route); lit dragon's fused route on the card
    against the CPU plain path on sampled ids; and K7 alone at both waves
    of dragon's chunk 37 (`time_redesigned`; with `parent`, the parent
    tree's K7 in turns, bitwise equal). With `parent`, the dragon frames
    of both routes again through the parent tree's kernels (K7; K3 and
    K4), bitwise equal to this tree's and timed in turns with them.
    Returns the launches, frame times and K7's timings."""
    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
    from skele_raytracer_tpu_torch.models.renderer import (
        _chunk_samples,
        render,
        render_ids_chunked,
    )
    from skele_raytracer_tpu_torch.ops.cuda import culled
    from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk

    out = {}
    for label, name, w, h, paths, warm in FUSED_FRAMES:
        cfg = RenderConfig(width=w, height=h, quirks=CLEAN, monte_carlo=True,
                           num_paths=paths, max_depth=2, use_shadows=True,
                           backend="cuda", fused_megakernel=True)
        scene = parsed_scene(name, CLEAN)
        fused = lambda: render(scene, cfg)
        reset_launches()
        img, fused_ms = timed(fused)
        launches = read_launches()
        chunks = -(-w * h // _chunk_samples(cfg))
        check(launches["fused_shade"] == 2 * chunks
              and sum(launches.values()) == launches["fused_shade"],
              f"fused {label}: launches {launches}, want {2 * chunks} "
              f"fused_shade and nothing else")
        check(tuple(img.shape) == (h, w, 3)
              and bool(torch.isfinite(img).all()), f"fused {label}: bad frame")
        split_cfg = cfg.replace(fused_megakernel=False)
        split_frame = lambda: render(scene, split_cfg)
        split, split_ms = timed(split_frame)
        share = float(torch.isclose(img, split, rtol=1e-3, atol=1e-3)
                      .float().mean())
        check(share >= 0.99,
              f"fused {label}: {share:.4%} within 1e-3 of split")
        if warm:
            fused_ms = statistics.median(cuda_ms(fused, warm))
            split_ms = statistics.median(cuda_ms(split_frame, warm))
        how = (f"median of {warm} warm frames" if warm
               else "the first frame of each route")
        print(f"[fused] {label} {w}x{h} clean gillum{paths} depth2 shadows, "
              f"fused_megakernel: launches {launches}; fused vs split "
              f"{share:.4%} of values within rtol 1e-3, atol 1e-3 (ok); on "
              f"{smi}: fused {fused_ms:.2f} ms, split {split_ms:.2f} ms per "
              f"frame ({how})")
        out[label] = dict(launches=launches, fused_ms=fused_ms,
                          split_ms=split_ms, share=share)
        if label == "dragon" and parent is not None:
            check(torch.equal(img, parent.call(None, fused))
                  and torch.equal(split, parent.call(None, split_frame)),
                  f"{label}: a frame differs through the parent tree's "
                  f"kernels")
            ms = turns_ms([fused, lambda: parent.call(None, fused), split_frame,
                           lambda: parent.call(None, split_frame)], reps=6)
            print(f"[fused] {label} {w}x{h} frames through this tree's and "
                  f"the parent tree's kernels, in turns (median of 6 frames "
                  f"each; bitwise equal) on {smi}: fused {ms[0]:.2f} ms, "
                  f"parent's K7 {ms[1]:.2f} ms; split {ms[2]:.2f} ms, "
                  f"parent's K3 and K4 {ms[3]:.2f} ms")
        if label == "dragon":
            # one chunk of the frame (chunk 37: 4,096 samples x 16 paths)
            # under the profiler, through each route
            ids = torch.arange(37 * 4096, 38 * 4096, device="cuda")
            for route, c, tags in (
                    ("fused", cfg, {"K7": "fused_kernel"}),
                    ("split", split_cfg, {"K3": "nearest_kernel",
                                          "K4": "occluded_kernel"})):
                chunk = lambda: render_ids_chunked(scene, c, 0, ids)
                profile_device(f"{label} {route} route, chunk 37", chunk,
                               statistics.median(cuda_ms(chunk, 3)), smi,
                               tags)

    cfg = RenderConfig(width=640, height=480, quirks=CLEAN, monte_carlo=True,
                       num_paths=16, max_depth=2, use_shadows=True,
                       backend="cuda", fused_megakernel=True)
    lit = lit_dragon("cuda")
    ids = torch.from_numpy(np.sort(np.random.default_rng(0).choice(
        640 * 480, 1024, replace=False)))
    got = render_ids_chunked(lit, cfg, 0, ids.cuda()).cpu()
    want = render_ids_chunked(lit_dragon("cpu"), cfg.replace(backend="torch"),
                              0, ids)
    frac, err, mdiff, ok = compare(got, want)
    print(f"[fused] lit dragon clean gillum16 fused: render_ids_chunked on "
          f"the card vs the plain path on the CPU, 1024 sampled ids: "
          f"{frac:.4%} off by >{ATOL:g}, max |diff| {err:.3e}, mean diff "
          f"{mdiff:.2e} ({'ok' if ok else 'FAIL'})")
    check(ok, "fused lit dragon: render disagrees with the plain path")

    # K7 alone at both waves of dragon's clean gillum16 chunk 37 (the
    # bounce wave dominates the frame)
    ids = torch.arange(37 * 4096, 38 * 4096, device="cuda")
    scene, waves = dragon_waves(CLEAN, ids, 16)
    tabs = mk.pack_tables(scene)
    o1, d1, lv = waves["bounce"]
    for wave, (o, d, live) in (("primary", (*waves["primary"], None)),
                               ("bounce", (o1, d1, lv))):
        order, lvs = mk.sort_rays(o, d, scene.clusters, live)
        feats = culled._ray_features10(o, d)[order].contiguous()
        outs = mk.fused_shade_forward(o, d, scene, use_shadows=True,
                                      live=live)
        live_txt = "" if live is None else f", {live.mean().item():.3f} live"
        out[wave] = time_redesigned(
            "fused_shade", f"dragon clean gillum16 chunk 37 {wave} wave "
            f"({o.shape[0]} rays, coarse{live_txt}, shadows)", o.shape[0],
            smi,
            lambda g: mk.fused_shade_kernel(feats, lvs, scene.clusters,
                                            *tabs, use_shadows=True, lanes=g),
            lambda g: f"fused_kernel<{g}, true>",
            lambda: mk.fused_shade_torch(feats, lvs, scene.clusters.rec,
                                         *tabs, use_shadows=True),
            fused_work(o, d, scene, outs, True, live=live), parent, mk, None,
            lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)))
    return out


def phase_fused_grad():
    """Gradients through K7 (lit dragon 160x120 clean gillum 4 depth 2
    shadows, 256 sampled ids, vertices, materials and the light's colour
    trainable): the card against the CPU plain path (GRAD_RTOL of each
    leaf's largest plus GRAD_ATOL), and fused against split on the card
    (tests/test_megakernel.py's bounds: materials and light colour within
    rtol 2e-3, atol 1e-5; >= 98% of vertex entries within rtol 1e-2, atol
    1e-4); then a 3-step fit through the fused route (FUSED_FIT_LR) whose
    losses must fall and which must refresh the clusters and the normal
    table after each step."""
    import dataclasses

    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.models.renderer import (
        render_ids_chunked,
        render_radiance,
    )
    from skele_raytracer_tpu_torch.ops.geometry import cross, normalize

    w, h = 160, 120
    ids = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        w * h, 256, replace=False)))
    tri_names = ("v0", "v1", "v2", "ambient", "diffuse", "specular")
    grads, launches = {}, {}
    for route, dev in (("fused", "cuda"), ("fused", "cpu"), ("split", "cuda")):
        cfg = RenderConfig(width=w, height=h, quirks=CLEAN, monte_carlo=True,
                           num_paths=4, max_depth=2, use_shadows=True,
                           backend="cuda" if dev == "cuda" else "torch",
                           fused_megakernel=route == "fused")
        scene = lit_dragon(dev)
        tris = dataclasses.replace(scene.triangles, **{
            k: getattr(scene.triangles, k).clone().requires_grad_(True)
            for k in tri_names})
        dl = dataclasses.replace(scene.directional_lights,
                                 colour=scene.directional_lights.colour
                                 .clone().requires_grad_(True))
        scene = dataclasses.replace(scene, triangles=tris,
                                    directional_lights=dl)
        reset_launches()
        r = render_ids_chunked(scene, cfg, 0, ids.to(dev))
        (r * r).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches[route, dev] = read_launches()
        grads[route, dev] = {k: getattr(tris, k).grad.cpu() for k in tri_names}
        grads[route, dev]["dl.colour"] = dl.colour.grad.cpu()
    lf = launches["fused", "cuda"]
    check(lf["fused_shade"] > 0 and sum(lf.values()) == lf["fused_shade"],
          f"the fused gradient launched {lf}")
    worst = 0.0
    for k, b in grads["fused", "cpu"].items():
        a = grads["fused", "cuda"][k]
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        check(scale > 0, f"fused gradient of {k} is zero")
        check(err <= GRAD_RTOL * scale + GRAD_ATOL,
              f"fused {k} gradient, card vs CPU, off by {err:.3e} (max "
              f"{scale:.3e})")
        worst = max(worst, err / scale)
    shares = []
    for k, a in grads["fused", "cuda"].items():
        b = grads["split", "cuda"][k]
        if k in ("v0", "v1", "v2"):
            share = float(torch.isclose(a, b, rtol=1e-2, atol=1e-4).float()
                          .mean())
            check(share >= 0.98, f"fused vs split {k} gradient: {share:.4%} "
                  f"within rtol 1e-2, atol 1e-4")
            shares.append(share)
        else:
            check(bool(torch.allclose(a, b, rtol=2e-3, atol=1e-5)),
                  f"fused vs split {k} gradient off by "
                  f"{(a - b).abs().max().item():.3e}")
    print(f"[fused] gradient, lit dragon {w}x{h} clean gillum4 depth2 "
          f"shadows, 256 sampled ids, triangles.v0/v1/v2/ambient/diffuse/"
          f"specular and the light's colour trainable: card vs CPU plain "
          f"path worst |diff|/max {worst:.3e}; fused vs split on the card: "
          f"materials and light colour within rtol 2e-3, vertex entries "
          f"{min(shares):.4%} within rtol 1e-2 (ok); launches {lf}")

    cfg = RenderConfig(width=w, height=h, quirks=CLEAN, monte_carlo=True,
                       num_paths=4, max_depth=2, use_shadows=True,
                       backend="cuda", fused_megakernel=True)
    scene = lit_dragon("cuda")
    with torch.no_grad():
        target = render_radiance(scene, cfg, TARGET_SEED)
    start = dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, v0=scene.triangles.v0 + 0.01))
    reset_launches()
    fitted, losses = train.fit(start, cfg, target, steps=TRAIN_STEPS,
                               learning_rate=FUSED_FIT_LR, log_every=0,
                               trainable_paths=("triangles",))
    torch.cuda.synchronize()
    lfit = read_launches()
    check(all(np.isfinite(losses)) and all(
        b < a for a, b in zip(losses, losses[1:])),
          f"fused fit losses not finite and decreasing: {losses}")
    check(lfit["fused_shade"] > 0
          and sum(lfit.values()) == lfit["fused_shade"],
          f"the fused fit launched {lfit}")
    tr = fitted.triangles
    perm = fitted.clusters.perm.long()
    real = fitted.clusters.mask > 0
    check(float((tr.v0 - start.triangles.v0).abs().max()) > 0,
          "the fused fit did not move the vertices")
    check(torch.equal(fitted.clusters.v0[real], tr.v0[perm[real]]),
          "clusters not refreshed after the fused fit")
    check(torch.equal(fitted.tri_normals,
                      normalize(cross(tr.v1 - tr.v0, tr.v2 - tr.v0))),
          "normal table not refreshed after the fused fit")
    print(f"[fused] fit of {TRAIN_STEPS} steps through K7 (triangles "
          f"trainable): losses {', '.join(f'{x:.6e}' for x in losses)}; "
          f"launches {lfit}; clusters and normal table rebuilt from the "
          f"moved vertices (ok)")
    return worst


# ---------------------------------------------------------------------------
# [whitted]: the clean Whitted integrator; [surface]: progressive rendering,
# --profile and the debug checks

WHITTED_DEPTH = 3
WHITTED_SAMPLED_IDS = 1024  # card vs CPU on this many sampled ids


def whitted_live_shares(scene, cfg, ids):
    """[(rays, live share)] of each wave of the Whitted frontier over
    `ids`: the frontier doubles and keeps its rows of weight 0, which the
    kernels skip through the live mask."""
    from skele_raytracer_tpu_torch.models import integrator
    from skele_raytracer_tpu_torch.models.renderer import render_ids_chunked

    real = integrator._shade_hit
    shares = []

    def spy(scene, cfg, seed, o, d, ids, bounce, live=None):
        shares.append((o.shape[0], float(live.mean())))
        return real(scene, cfg, seed, o, d, ids, bounce, live)

    integrator._shade_hit = spy
    try:
        render_ids_chunked(scene, cfg, 0, ids)
    finally:
        integrator._shade_hit = real
    return shares


def card_vs_cpu(label, scene_fn, cfg, n, seed=0):
    """`render_ids_chunked` on the card against the same code on the CPU
    (the kernels' plain versions) on n sampled ids, at `compare`'s
    tolerance; scene_fn(device) builds the scene."""
    from skele_raytracer_tpu_torch.models.renderer import render_ids_chunked

    total = cfg.width * cfg.height * cfg.samples_per_pixel
    ids = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
        total, n, replace=False)))
    got = render_ids_chunked(scene_fn("cuda"), cfg, 0, ids.cuda()).cpu()
    want = render_ids_chunked(scene_fn("cpu"), cfg.replace(backend="torch"),
                              0, ids)
    frac, err, mdiff, ok = compare(got, want)
    print(f"[whitted] {label}: render_ids_chunked on the card vs the plain "
          f"path on the CPU, {n} sampled ids: {frac:.4%} off by >{ATOL:g}, "
          f"max |diff| {err:.3e}, mean diff {mdiff:.2e} "
          f"({'ok' if ok else 'FAIL'})")
    check(ok, f"{label}: the card disagrees with the plain path")


def whitted_frame(label, scene, cfg, smi, want):
    """`render` of a Whitted frame with the launch counters set to 0 just
    before and read just after (`want(launches)` must hold), then timed:
    median of 3 warm frames by CUDA events. Returns (frame, launches,
    ms)."""
    from skele_raytracer_tpu_torch.models.renderer import render

    frame = lambda: render(scene, cfg)
    reset_launches()
    img = frame()
    torch.cuda.synchronize()
    launches = read_launches()
    check(tuple(img.shape) == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(img).all()), f"{label}: bad frame")
    check(want(launches), f"{label}: unexpected launches {launches}")
    ms = statistics.median(cuda_ms(frame, 3))
    print(f"[whitted] {label} {cfg.width}x{cfg.height} clean depth "
          f"{cfg.max_depth} shadows: launches per frame "
          f"{ {k: v for k, v in launches.items() if v} }; on {smi}: "
          f"{ms:.2f} ms per frame (median of 3 warm frames)")
    return img, launches, ms


def whitted_routes(label, scene, cfg, smi, chunk_index):
    """The split and the fused route of one Whitted frame: split launches
    K3 and K4 and neither K1 nor K7, fused only K7; >= 99% of the fused
    frame's values within 1e-3 of the split one's; each timed, with its
    launches per frame, a device profile of one chunk (idle share) and
    the live share of each of that chunk's waves."""
    from skele_raytracer_tpu_torch.models.renderer import (
        _chunk_samples,
        render_ids_chunked,
    )

    def split_ok(n):
        return (n["culled_nearest"] > 0 and n["culled_occluded"] > 0
                and n["pathtrace"] == 0 and n["fused_shade"] == 0)

    def fused_ok(n):
        return n["fused_shade"] > 0 and sum(n.values()) == n["fused_shade"]

    fused_cfg = cfg.replace(fused_megakernel=True)
    split, split_n, split_ms = whitted_frame(f"{label} split", scene, cfg,
                                             smi, split_ok)
    fused, fused_n, fused_ms = whitted_frame(f"{label} fused", scene,
                                             fused_cfg, smi, fused_ok)
    share = float(torch.isclose(fused, split, rtol=1e-3, atol=1e-3)
                  .float().mean())
    print(f"[whitted] {label}: fused vs split {share:.4%} of values within "
          f"rtol 1e-3, atol 1e-3")
    check(share >= 0.99, f"{label}: fused vs split {share:.4%} within 1e-3")
    n = _chunk_samples(cfg)
    ids = torch.arange(chunk_index * n, (chunk_index + 1) * n, device="cuda")
    lives = whitted_live_shares(scene, cfg, ids)
    print(f"[whitted] {label} chunk {chunk_index} ({n} samples): rays and "
          f"live share per wave "
          + ", ".join(f"{r} {s:.1%}" for r, s in lives))
    for route, c, tags in (("split", cfg, {"K3": "nearest_kernel",
                                           "K4": "occluded_kernel"}),
                           ("fused", fused_cfg, {"K7": "fused_kernel"})):
        chunk = lambda: render_ids_chunked(scene, c, 0, ids)
        profile_device(f"{label} Whitted {route} route, chunk {chunk_index}",
                       chunk, statistics.median(cuda_ms(chunk, 3)), smi, tags)
    return dict(split_ms=split_ms, fused_ms=fused_ms, split=split_n,
                fused=fused_n, share=share, lives=lives)


def phase_whitted(smi):
    """The clean Whitted integrator on the card: test.scn through the CLI
    at its 1024x768 (K3 and K4, neither K1 nor K7; the launch counters set
    to 0 just before and read just after); the same frame through
    `render`, split against the CPU on sampled ids and against the fused
    route; spheres2 1920x1080 (glass of ior 1.1-1.5: refraction and total
    internal reflection), which launches no kernel, against the CPU; lit
    dragon 640x480 split and fused; a Whitted gradient of lit dragon's
    vertices through K3/K4 against the CPU. Returns the numbers."""
    from skele_raytracer_tpu_torch import cli
    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig

    os.makedirs(SCRATCH, exist_ok=True)
    out = os.path.join(SCRATCH, "whitted.ppm")
    argv = ["--path", os.path.join(SCENES, "test.scn"), "--output", out,
            "--mode", "clean", "--shadow", "--depth", str(WHITTED_DEPTH)]
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(rc == 0, f"cli.main returned {rc}")
    check_ppm(out, 1024, 768)
    check(launches["culled_nearest"] > 0 and launches["culled_occluded"] > 0
          and launches["pathtrace"] == 0 and launches["fused_shade"] == 0,
          f"the test.scn Whitted run did not take K3 and K4 alone: "
          f"{launches}")
    print(f"[whitted] cli.main {' '.join(argv[4:])} (test.scn, 1024x768) -> "
          f"rc {rc}, P6 1024x768, {wall:.2f} s wall with parse and PPM; "
          f"launches {launches}")
    res = {"cli": launches}

    base = dict(quirks=CLEAN, max_depth=WHITTED_DEPTH, use_shadows=True,
                backend="cuda")
    cfg = RenderConfig(width=1024, height=768, **base)
    scene = parsed_scene("test.scn", CLEAN)
    card_vs_cpu("test.scn 1024x768 Whitted split",
                lambda dev: parsed_scene("test.scn", CLEAN, dev), cfg,
                WHITTED_SAMPLED_IDS)
    res["test.scn"] = whitted_routes("test.scn", scene, cfg, smi, 24)

    cfg = RenderConfig(width=1920, height=1080, **base)
    scene = parsed_scene("spheres2.scn", CLEAN)
    _, n, ms = whitted_frame("spheres2", scene, cfg, smi,
                             lambda n: sum(n.values()) == 0)
    card_vs_cpu("spheres2 1920x1080 Whitted",
                lambda dev: parsed_scene("spheres2.scn", CLEAN, dev), cfg,
                WHITTED_SAMPLED_IDS)
    res["spheres2"] = dict(ms=ms, launches=n)

    cfg = RenderConfig(width=640, height=480, **base)
    res["lit dragon"] = whitted_routes("lit dragon", lit_dragon("cuda"), cfg,
                                       smi, 9)

    # the Whitted gradient: lit dragon's vertices through K3/K4's replay
    import dataclasses

    from skele_raytracer_tpu_torch.models.renderer import render_ids_chunked

    w, h, n_ids = 160, 120, 256
    ids = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        w * h, n_ids, replace=False)))
    names = ("v0", "v1", "v2")
    grads = {}
    for dev in ("cuda", "cpu"):
        cfg = RenderConfig(width=w, height=h, quirks=CLEAN, max_depth=2,
                           use_shadows=True,
                           backend="cuda" if dev == "cuda" else "torch")
        scene = lit_dragon(dev)
        tris = dataclasses.replace(scene.triangles, **{
            k: getattr(scene.triangles, k).clone().requires_grad_(True)
            for k in names})
        scene = dataclasses.replace(scene, triangles=tris)
        if dev == "cuda":
            reset_launches()
        r = render_ids_chunked(scene, cfg, 0, ids.to(dev))
        (r * r).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_launches()
        grads[dev] = [getattr(tris, k).grad.cpu() for k in names]
    check(launches["culled_nearest"] > 0 and launches["culled_occluded"] > 0
          and launches["pathtrace"] == 0 and launches["fused_shade"] == 0,
          f"the Whitted gradient did not run K3 and K4: {launches}")
    worst = 0.0
    for k, a, b in zip(names, grads["cuda"], grads["cpu"]):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        check(scale > 0, f"Whitted dragon {k} gradient is zero")
        check(err <= GRAD_RTOL * scale + GRAD_ATOL,
              f"Whitted dragon {k} gradient off by {err:.3e} (max "
              f"{scale:.3e})")
        worst = max(worst, err / scale)
    print(f"[whitted] gradient: lit dragon {w}x{h} clean Whitted depth 2 "
          f"shadows, {n_ids} sampled ids, triangles.v0/v1/v2 trainable: card "
          f"vs CPU plain path, worst |diff|/max {worst:.3e}, nonzero; "
          f"launches {launches} (ok)")
    res["grad_worst"] = worst
    return res


def phase_surface(smi):
    """Progressive rendering, --profile and the debug checks on the card:
    the 1080p spheres2 parity headline through the CLI in 64-row bands
    with a resume state and a preview, killed after 4 bands
    (SKT_FAULT_AFTER_BANDS, a subprocess that must exit nonzero and leave
    the state and the preview), then resumed in this process (the launch
    counters set to 0 just before and read just after: one K1 launch per
    remaining band), byte-equal to a one-shot CLI render; the bands'
    cost beside one-shot `render`; `--profile` on a test.scn Whitted run
    (256x192, a process of its own), whose trace must name K3's and K4's
    kernels; `debug.checked_render`
    of test.scn 64x48 clean Whitted on the card."""
    from skele_raytracer_tpu_torch import cli
    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
    from skele_raytracer_tpu_torch.models import progressive
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.utils import debug, profiling

    os.makedirs(SCRATCH, exist_ok=True)
    state = os.path.join(SCRATCH, "progressive_state.npz")
    preview = os.path.join(SCRATCH, "previews")
    resumed = os.path.join(SCRATCH, "resumed.ppm")
    one_shot = os.path.join(SCRATCH, "oneshot.ppm")
    for path in (state, os.path.join(preview, "preview.ppm")):
        if os.path.exists(path):
            os.remove(path)
    head = ["--path", os.path.join(SCENES, "spheres2.scn"), "--width",
            "1920", "--height", "1080", "--gillum", "16", "--depth", "2",
            "--shadow"]
    prog = ["--band-rows", "64", "--resume", state, "--preview-dir", preview]
    env = dict(os.environ, PYTHONPATH=REPO,
               **{progressive.FAULT_AFTER_BANDS_ENV: "4"})
    proc = subprocess.run(
        [sys.executable, "-m", "skele_raytracer_tpu_torch", *head, *prog,
         "--output", resumed], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    check(proc.returncode != 0 and "injected fault" in proc.stderr,
          f"the faulted run exited {proc.returncode}: {proc.stderr[-1500:]}")
    check(os.path.exists(state) and os.path.exists(
        os.path.join(preview, "preview.ppm")),
          "the faulted run left no state or no preview")
    done = int(np.load(state)["next_band"])
    check(done == 4, f"the state holds {done} bands, want 4")
    bands = -(-1080 // 64)
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*head, *prog, "--output", resumed])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = read_launches()
    check(rc == 0 and not os.path.exists(state),
          f"the resumed run returned {rc} or left its state")
    check(launches["pathtrace"] == bands - done
          and sum(launches.values()) == launches["pathtrace"],
          f"the resume launched {launches}, want {bands - done} K1 launches")
    check(cli.main([*head, "--output", one_shot]) == 0, "one-shot failed")
    with open(resumed, "rb") as a, open(one_shot, "rb") as b:
        check(a.read() == b.read(), "the resumed PPM differs from one-shot")
    print(f"[surface] progressive spheres2 1920x1080 parity gillum16 depth2 "
          f"shadows, 64-row bands: the run killed after 4 of {bands} bands "
          f"exited {proc.returncode} and left its state and preview; the "
          f"resume ran {bands - done} bands ({launches['pathtrace']} K1 "
          f"launches, {resume_s:.2f} s wall with parse and PPM), its PPM "
          f"byte-equal to a one-shot render (ok)")

    cfg = RenderConfig(width=1920, height=1080, monte_carlo=True,
                       num_paths=16, max_depth=2, use_shadows=True,
                       backend="cuda")
    scene = parsed_scene("spheres2.scn", cfg.quirks)
    oneshot = lambda: render(scene, cfg)
    banded = lambda: progressive.render_progressive(scene, cfg, band_rows=64)
    for fn in (oneshot, banded):
        fn()
    torch.cuda.synchronize()
    walls = {}
    for name, fn in (("one-shot", oneshot), ("banded", banded)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        walls[name] = statistics.median(times)
    print(f"[surface] progressive headline on {smi}: {bands} bands of 64 "
          f"rows {walls['banded']:.2f} ms ({walls['banded'] / bands:.3f} ms "
          f"per band, the frame on the host as numpy) vs one-shot `render` "
          f"{walls['one-shot']:.2f} ms (wall, median of 3 warm runs)")

    trace_dir = os.path.join(SCRATCH, "profile")
    trace = os.path.join(trace_dir, profiling.TRACE_FILE)
    if os.path.exists(trace):
        os.remove(trace)
    # a process of its own, as a user runs it (and out of reach of this
    # process's earlier profiler traces)
    argv = ["--path", os.path.join(SCENES, "test.scn"), "--output",
            os.path.join(SCRATCH, "whitted_profiled.ppm"), "--width", "256",
            "--height", "192", "--mode", "clean", "--shadow", "--depth",
            str(WHITTED_DEPTH), "--profile", trace_dir]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "skele_raytracer_tpu_torch", *argv], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"the --profile run failed: {proc.stderr[-1500:]}")
    with open(trace) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    k3 = sum("nearest_kernel<" in k for k in names)
    k4 = sum("occluded_kernel<" in k for k in names)
    check(k3 > 0 and k4 > 0, f"the --profile trace names {k3} K3 and {k4} "
          f"K4 kernels")
    print(f"[surface] --profile on test.scn 256x192 clean Whitted depth "
          f"{WHITTED_DEPTH} shadows: {os.path.getsize(trace)} bytes, "
          f"{len(names)} kernel events, {k3} of K3, {k4} of K4 (ok)")

    cfg = RenderConfig(width=64, height=48, quirks=CLEAN,
                       max_depth=WHITTED_DEPTH, use_shadows=True,
                       backend="cuda")
    reset_launches()
    t0 = time.perf_counter()
    img = debug.checked_render(parsed_scene("test.scn", CLEAN), cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    check(tuple(img.shape) == (48, 64, 3) and bool(torch.isfinite(img).all())
          and launches["culled_nearest"] > 0
          and launches["culled_occluded"] > 0,
          f"checked_render: bad frame or launches {launches}")
    print(f"[surface] debug.checked_render test.scn 64x48 clean Whitted "
          f"depth {WHITTED_DEPTH} shadows on the card: no NaN from any op or "
          f"kernel output, {time.perf_counter() - t0:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} } (ok)")
    return dict(resume_launches=launches, walls=walls)


PARALLEL_SHARDS = 4  # shards of the one card in [parallel]
GLOO_RANKS = 2  # ranks of the gloo group spawned on the one card
STEP_LOSS_RTOL = 1e-6  # a sharded step's loss vs the single-device step's
# a sharded step's gradients vs the single-device step's: |g - ref| <= atol +
# rtol |ref| (tests/test_sharding.py's tolerance); its updated leaves
SHARD_GRAD_ATOL, SHARD_GRAD_RTOL, LEAF_ATOL = 1e-5, 1e-3, 1e-6


def _grads(scene) -> dict:
    """{leaf path: its .grad, zeros where it has none} of a state's scene."""
    from skele_raytracer_tpu_torch.scene.types import leaf_items

    return {name: torch.zeros_like(t) if t.grad is None else t.grad
            for name, t in leaf_items(scene)}


def parallel_rank(rank, init_url, out):
    """One rank of the gloo group that `phase_parallel` spawns on the one
    card: the 1080p parity headline over `multihost.global_mesh()` (one
    shard per rank, on cuda:0), its frame gathered on rank 0; one sharded
    `train_step` from `perturbed(scene)`; the all-reduce of a buffer the
    size of the step's, on the card and on the host (each after a barrier,
    median of 10). Rank 0 saves the frame, the loss, the updated leaves,
    its launch counts and the all-reduce's times in `out` (.npz). Returns
    0."""
    import torch.distributed as dist

    from skele_raytracer_tpu_torch.config import PARITY
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.parallel import api, multihost
    from skele_raytracer_tpu_torch.scene.types import leaf_items

    multihost.initialize(init_url, GLOO_RANKS, rank, backend="gloo")
    try:
        scene, cfg = headline(PARITY)
        mesh = multihost.global_mesh()
        check(mesh.n_shards == GLOO_RANKS and mesh.devices == (
            torch.device("cuda", 0),), f"rank {rank}: mesh {mesh}")
        reset_launches()
        frame = multihost.gather_image(api.render_sharded(scene, cfg, 0,
                                                          mesh))
        render_launches = read_launches()
        target = render(scene, cfg, TARGET_SEED)
        state = train.init_state(perturbed(scene), TRAIN_LR)
        reset_launches()
        state, loss = train.train_step(state, cfg, 0, target, mesh=mesh)
        torch.cuda.synchronize()
        step_launches = read_launches()
        n = sum(t.numel() for _, t in leaf_items(state.scene)) + 1
        ms = {}
        for where in ("cuda", "cpu"):  # the step's buffer, and on the host
            buf = torch.ones(n, device=where)
            times = []
            for _ in range(11):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(buf)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[where] = statistics.median(times[1:])
        if rank == 0:
            np.savez(out, frame=frame, loss=float(loss),
                     allreduce_ms=ms["cuda"], allreduce_host_ms=ms["cpu"],
                     allreduce_floats=n,
                     launches=json.dumps([render_launches, step_launches]),
                     **{f"leaf:{name}": t.detach().cpu().numpy()
                        for name, t in leaf_items(state.scene)})
        else:
            check(frame is None, "a rank other than 0 got the frame")
    finally:
        dist.destroy_process_group()
    return 0


def spawn_gloo_ranks(out):
    """Run `parallel_rank` in GLOO_RANKS processes of their own (a file
    rendezvous under SCRATCH), each reaped within 300 s; returns rank 0's
    .npz and the seconds the group took."""
    init = os.path.join(SCRATCH, "gloo_init")
    for path in (init, out):
        if os.path.exists(path):
            os.remove(path)
    code = ("import sys, chip_smoke; sys.exit(chip_smoke.parallel_rank("
            "int(sys.argv[1]), sys.argv[2], sys.argv[3]))")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), f"file://{init}", out],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(GLOO_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300))
    finally:
        for p in procs:  # a rank left waiting on a dead peer
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        check(p.returncode == 0,
              f"gloo rank {r} exited {p.returncode}: {err[-2000:]}")
    return np.load(out), time.perf_counter() - t0


def phase_parallel(smi):
    """Rays sharded over devices and processes, on the one card (NCCL
    across cards and multi-GPU scaling need a machine with more than one):
    the 1080p parity headline through `render_radiance_sharded` on a
    PARALLEL_SHARDS-shard mesh of cuda:0 (one K1 launch per shard; bitwise
    the one-shot `render`), timed in turns with one-shot; a sharded
    `train_step` (one K1-with-records and one K2 launch per shard; loss and
    gradients against the single-device step's); the same frame and step
    in a GLOO_RANKS-rank gloo group on the card (frame gathered on rank 0,
    bitwise; loss and updated leaves against the single-process step) with
    the all-reduce's time; `multihost.scaling_report` at 1, 2 and 4 shards
    of the card, which is what sharding costs on one card, not how it
    scales. Each run with the launch counters set to 0 just before and
    read just after."""
    from skele_raytracer_tpu_torch.config import PARITY
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.parallel import api, multihost
    from skele_raytracer_tpu_torch.scene.types import leaf_items

    t_phase = time.perf_counter()
    os.makedirs(SCRATCH, exist_ok=True)
    scene, cfg = headline(PARITY)
    card = torch.device("cuda", 0)
    mesh = api.make_mesh([card] * PARALLEL_SHARDS)
    one = render(scene, cfg)
    reset_launches()
    frame = api.render_sharded(scene, cfg, 0, mesh)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["pathtrace"] == PARALLEL_SHARDS
          and sum(launches.values()) == PARALLEL_SHARDS,
          f"the {PARALLEL_SHARDS}-shard frame launched {launches}")
    check(torch.equal(frame, one), "the sharded frame differs from one-shot")
    one_ms, shard_ms = turns_ms(
        [lambda: render(scene, cfg),
         lambda: api.render_sharded(scene, cfg, 0, mesh)], reps=6)
    print(f"[parallel] spheres2 1920x1080 parity gillum16 depth2 shadows "
          f"over {PARALLEL_SHARDS} shards of {card} ({mesh.axis_sizes} "
          f"tiles x samples): {launches['pathtrace']} K1 launches, the frame "
          f"bitwise equal to one-shot `render`; on {smi}: sharded "
          f"{shard_ms:.4f} ms vs one-shot {one_ms:.4f} ms (CUDA events, "
          f"median of 6 in turns) (ok)")

    target = render(scene, cfg, TARGET_SEED)
    start = perturbed(scene)
    s1 = train.init_state(start, TRAIN_LR)
    s1, loss1 = train.train_step(s1, cfg, 0, target)
    g1 = _grads(s1.scene)
    s4 = train.init_state(start, TRAIN_LR)
    reset_launches()
    s4, loss4 = train.train_step(s4, cfg, 0, target, mesh=mesh)
    torch.cuda.synchronize()
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want.update(pathtrace_records=PARALLEL_SHARDS,
                pathtrace_bwd=PARALLEL_SHARDS)
    check(launches == want, f"the sharded step launched {launches}")
    loss_rel = abs(float(loss4) - float(loss1)) / abs(float(loss1))
    check(loss_rel <= STEP_LOSS_RTOL,
          f"sharded step loss {float(loss4)!r} vs {float(loss1)!r}")
    worst = 0.0
    for name, g in _grads(s4.scene).items():
        diff, ref = (g - g1[name]).abs(), g1[name].abs()
        excess = float((diff - SHARD_GRAD_ATOL - SHARD_GRAD_RTOL * ref).max())
        check(excess <= 0, f"sharded gradient {name} off by {excess:.3e} "
              f"beyond {SHARD_GRAD_ATOL} + {SHARD_GRAD_RTOL} |ref|")
        worst = max(worst, float(diff.max()))
    fresh = train.init_state(start, TRAIN_LR).scene
    one_step = lambda: train.full_loss(fresh, cfg, 0, target).backward()
    shard_step = lambda: api.loss_and_grad_sharded(fresh, cfg, 0, target,
                                                   mesh)
    one_ms, shard_ms = turns_ms([one_step, shard_step], reps=6)
    print(f"[parallel] sharded train_step at the headline over "
          f"{PARALLEL_SHARDS} shards: launches {launches}; loss "
          f"{float(loss4):.9e} vs single-device {float(loss1):.9e} "
          f"(relative {loss_rel:.2e}); gradients within {SHARD_GRAD_ATOL} + "
          f"{SHARD_GRAD_RTOL} |ref| (max |diff| {worst:.3e}); on {smi}: "
          f"loss and gradient sharded {shard_ms:.4f} ms vs single-device "
          f"forward + backward {one_ms:.4f} ms (CUDA events, median of 6 in "
          f"turns) (ok)")

    got, group_s = spawn_gloo_ranks(os.path.join(SCRATCH, "gloo_rank0.npz"))
    render_l, step_l = json.loads(str(got["launches"]))
    check(np.array_equal(got["frame"], one.cpu().numpy()),
          "the gloo group's gathered frame differs from one-shot")
    check(render_l["pathtrace"] == 1 and step_l["pathtrace_records"] == 1
          and step_l["pathtrace_bwd"] == 1,
          f"gloo rank 0 launched {render_l}, {step_l}")
    g_rel = abs(float(got["loss"]) - float(loss1)) / abs(float(loss1))
    check(g_rel <= STEP_LOSS_RTOL,
          f"gloo step loss {float(got['loss'])!r} vs {float(loss1)!r}")
    leaf_err = max(float(np.abs(got[f"leaf:{name}"]
                                - t.detach().cpu().numpy()).max(initial=0))
                   for name, t in leaf_items(s1.scene))
    check(leaf_err <= LEAF_ATOL, f"gloo step leaves off by {leaf_err:.3e}")
    moved = any(not np.array_equal(got[f"leaf:{name}"],
                                   t.detach().cpu().numpy())
                for name, t in leaf_items(start))
    check(moved, "the gloo step moved no leaf")
    print(f"[parallel] {GLOO_RANKS}-rank gloo group on {card} (one shard "
          f"per rank): the frame gathered on rank 0 bitwise equal to one-shot "
          f"(rank 0 launched {render_l['pathtrace']} K1); one step's loss "
          f"{float(got['loss']):.9e} (relative {g_rel:.2e}), updated leaves "
          f"within {leaf_err:.2e} of the single-process step; gloo "
          f"all-reduce of {int(got['allreduce_floats'])} float32 on the card "
          f"{float(got['allreduce_ms']):.4f} ms, of the same buffer on the "
          f"host {float(got['allreduce_host_ms']):.4f} ms on {smi} (host "
          f"clock around a synchronized call after a barrier, median of "
          f"10); the group took "
          f"{group_s:.1f} s wall with start-up (ok)")

    rows = multihost.scaling_report(scene, cfg, devices=[card] * 4,
                                    device_counts=[1, 2, 4])
    print(f"[parallel] overhead of sharding on one card (not scaling: every "
          f"shard runs on {card}) on {smi}, `render_sharded` wall per frame, "
          f"mean of 3 warm: " + ", ".join(
              f"{r['devices']} shards {r['seconds'] * 1e3:.4f} ms "
              f"({r['rays_per_sec'] / rows[0]['rays_per_sec']:.3f}x the "
              f"1-shard rays/s)" for r in rows))
    print(f"[parallel] the parallel phase took "
          f"{time.perf_counter() - t_phase:.1f} s wall")


def phase_example(smi):
    """examples/inverse_rendering_torch.py at its defaults on the card
    (spheres1 160x120, shadows, 200 steps, lr 5e-3, diffuse and light
    colour trainable) in a process of its own: its PPMs written, its
    logged losses falling, its MAE printed."""
    import shutil

    out = os.path.join(SCRATCH, "inverse_rendering")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join("examples",
                                      "inverse_rendering_torch.py"),
         "--out", out], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the example exited {proc.returncode}: {proc.stderr[-2000:]}")
    losses = [float(line.split()[-1]) for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    check(len(losses) >= 2 and losses[-1] < losses[0],
          f"the example's losses did not fall: {losses}")
    for name in ("target.ppm", "initial.ppm", "fitted.ppm"):
        check_ppm(os.path.join(out, name), 160, 120)
    summary = [line for line in proc.stdout.splitlines()
               if "final image MAE" in line]
    check(summary, "the example printed no MAE")
    print(f"[example] examples/inverse_rendering_torch.py at its defaults on "
          f"{smi}: logged losses {', '.join(f'{x:.6e}' for x in losses)}; "
          f"{summary[0]}; {wall:.1f} s wall with start-up (ok)")


def phase_roofline(smi, parity):
    """`utils/roofline.analyze_trace` of the --profile trace that
    `phase_surface` wrote, and `sol_summary` of K1's counted work at the
    1080p parity headline from `render`'s wall time and K1's time."""
    from skele_raytracer_tpu_torch.config import PARITY
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt
    from skele_raytracer_tpu_torch.utils import roofline

    stats = roofline.analyze_trace(os.path.join(SCRATCH, "profile"))
    check(stats, "analyze_trace found no kernel in the --profile trace")
    busy = sum(s.total_s for s in stats)
    top = "; ".join(
        f"{s.name[:48]} {s.total_s * 1e3:.3f} ms x{s.count}"
        + (f" {s.physical_gbps:.1f} GB/s ({s.sol_pct:.2f}% of HBM)"
           if s.physical_bytes else "") for s in stats[:5])
    print(f"[roofline] analyze_trace of the test.scn Whitted --profile "
          f"trace: {len(stats)} kernels, {busy * 1e3:.3f} ms of device time; "
          f"top 5: {top}")
    scene, cfg = headline(PARITY)
    n = cfg.width * cfg.height * cfg.samples_per_pixel
    model = k1_model(pt._static_kernel_args(scene, cfg), n)
    sol = roofline.sol_summary(model, parity["render_ms"] / 1e3,
                               parity["kernel_ms"] / 1e3)
    print(f"[roofline] K1's counted work at the 1080p parity headline on "
          f"{smi}, `render` {parity['render_ms']:.4f} ms wall, K1 "
          f"{parity['kernel_ms']:.4f} ms (the [main] line's): "
          f"{json.dumps(sol)}")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", help="an earlier tree's csrc/ whose K1, "
                    "K5 and K7 are checked against and timed in turns with "
                    "this tree's")
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    parent = ParentKernels(args.parent_csrc) if args.parent_csrc else None
    phase_sass(parent)
    phase_sass_lab(parent)
    worst_small = phase_kernel_vs_plain()
    worst_mesh = phase_mesh_kernels_vs_plain()
    t0 = time.perf_counter()
    k6 = phase_k6(smi)
    fused_err = phase_fused_kernels()
    lanes_err = phase_lanes_vs_plain()
    t1 = time.perf_counter()
    fused = phase_fused_main(smi, parent)
    t2 = time.perf_counter()
    phase_fused_grad()
    t3 = time.perf_counter()
    print(f"[fused] the fused phases took {t3 - t0:.1f} s wall: kernel "
          f"checks {t1 - t0:.1f} s, main path {t2 - t1:.1f} s, gradient and "
          f"fit {t3 - t2:.1f} s")
    phase_goldens()
    launches, parity = phase_main_path(smi)
    phase_k1_headlines(smi, parent)
    mesh_counts = phase_mesh_main_path()
    times = phase_mesh_timings(smi, parent)
    lab_rows = phase_lab(smi)
    phase_median(smi)
    phase_fd()
    t0 = time.perf_counter()
    rec_err, k2_err = phase_k2_headline()
    phase_k2_lights()
    phase_train_routes()
    trained = phase_train_headline(smi, parent)
    phase_grad_mesh()
    print(f"[train] the training phases took {time.perf_counter() - t0:.1f} "
          f"s wall")
    t0 = time.perf_counter()
    phase_whitted(smi)
    t1 = time.perf_counter()
    phase_surface(smi)
    print(f"[surface] the Whitted phase took {t1 - t0:.1f} s wall, the "
          f"surface phase {time.perf_counter() - t1:.1f} s")
    phase_parallel(smi)
    t0 = time.perf_counter()
    phase_example(smi)
    phase_roofline(smi, parity)
    print(f"[example] the example and roofline phases took "
          f"{time.perf_counter() - t0:.1f} s wall")
    tp = trained["parity"]
    static, n = tp["static"], tp["n"]
    kernels = [
        dict(name="pathtrace", route="cuda",
             source="skele_raytracer_tpu_torch/csrc/pathtrace.cu",
             replaces="skele_raytracer_tpu/ops/pallas/pathtrace.py:1031",
             launches=launches["pathtrace"],
             max_abs_err=max(parity["err"], worst_small["pathtrace"]),
             ms=parity["kernel_ms"], plain_ms=parity["plain_ms"]),
        dict(name="pathtrace_records", route="cuda",
             source="skele_raytracer_tpu_torch/csrc/pathtrace.cu",
             replaces="skele_raytracer_tpu/ops/pallas/pathtrace.py:1031",
             launches=tp["launches"]["pathtrace_records"],
             max_abs_err=max(worst_small["pathtrace_records"], rec_err),
             ms=tp["k1r_ms"], plain_ms=tp["k1r_plain_ms"]),
        dict(name="pathtrace_bwd", route="cuda",
             source="skele_raytracer_tpu_torch/csrc/pathtrace_bwd.cu",
             replaces="skele_raytracer_tpu/ops/pallas/pathtrace.py:1231",
             launches=tp["launches"]["pathtrace_bwd"],
             max_abs_err=max(worst_small["pathtrace_bwd"], k2_err,
                             *(m["k2_err"] for m in trained.values())),
             ms=tp["k2_ms"], plain_ms=tp["k2_plain_ms"]),
    ]
    bounds = [k1_work(static, n), k1_work(static, n, records=True),
              k2_work(static, n)]
    for k, (b_ms, b_by) in zip(kernels, bounds):
        k.update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # ms / plain_ms: the chunk of the dragon clean gillum16 frame that
    # dominates it (the bounce wave); launches: that frame's CLI run. K3's,
    # K4's and K5's ms (and K7's below) are device time per launch from the
    # profiler (`time_redesigned`); one wrapper call by CUDA events, which
    # adds the wrapper's host time, is on each one's `[time]` line.
    mesh = [
        ("culled_nearest", "culled.cu", "culled.py:184", "clean gillum16",
         "bounce"),
        ("culled_occluded", "culled.cu", "culled.py:691", "clean gillum16",
         "bounce"),
        ("triangle_nearest", "intersect.cu", "intersect.py:184", "k5",
         "primary"),
    ]
    for name, src, tpu, run, wave in mesh:
        ms, plain_ms, b_ms, b_by = times[name, wave][:4]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"skele_raytracer_tpu_torch/csrc/{src}",
            replaces=f"skele_raytracer_tpu/ops/pallas/{tpu}",
            launches=mesh_counts[run][name],
            max_abs_err=worst_mesh[name], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    ft = fused["bounce"]
    kernels += [
        dict(name="fused_shade", route="cuda",
             source="skele_raytracer_tpu_torch/csrc/megakernel.cu",
             replaces="skele_raytracer_tpu/ops/pallas/megakernel.py:170",
             launches=fused["dragon"]["launches"]["fused_shade"],
             max_abs_err=max(*fused_err, *lanes_err), ms=ft[0],
             plain_ms=ft[1],
             bound_ms=ft[2], bound_by=ft[3], library_ms=None),
        dict(name="sphere_nearest", route="cuda",
             source="skele_raytracer_tpu_torch/csrc/intersect.cu",
             replaces="skele_raytracer_tpu/ops/pallas/intersect.py:85",
             launches=fused["dragon"]["launches"]["sphere_nearest"],
             max_abs_err=k6["err"], ms=k6["ms"], plain_ms=k6["plain_ms"],
             bound_ms=k6["bound"][0], bound_by=k6["bound"][1],
             library_ms=None),
    ]
    # the lab's kernels: launches from the dragon clean CLI run (no render
    # path launches them)
    for kind, row in lab_rows.items():
        kernels.append(dict(row,
                            launches=mesh_counts["clean gillum16"][kind]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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
  kernel K6, which no render path launches.

Phases, in order; any failure raises and exits nonzero:

1. device: nvidia-smi's name and power limit, torch and CUDA versions;
   no GPU -> exit 1 before anything else.
2. build: nvcc builds every kernel library from
   skele_raytracer_tpu_torch/csrc/, one nvcc per source, all at once.
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
   and indices equal on every ray, t within 1e-6 relative. Each case must
   launch its kernel.
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
   against the plain path (the same code on the CPU) on sampled ids, and
   timings with CUDA events over warm runs: each kernel alone and its
   plain version at one main-path chunk's shape (K3 and K7 at both waves
   of dragon's chunk 37, K4 at its two shadow waves, by profiler device
   time, each lane count too: `[tune]`), and `render` end to end.
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
7. a JSON line of the kernels (with each one's bound from counted
   operations and bytes), nvidia-smi's line, and the final line
   {"ok": true, "device": {...}}.

With `--parent-csrc DIR` (an earlier commit's skele_raytracer_tpu_torch/
csrc, e.g. `git archive` of it unpacked under build/), that tree's K4 and
K2 are built too and timed in turns with this tree's on the same inputs
(K4 at dragon's shadow waves, K2 and a `train_step` at the 1080p
headlines, K2 at 22 and 32 lights), and the split dragon frame with
each.

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

# Peak rates of one H100 SXM at 700 W for the bounds: FP32 and HBM from
# NVIDIA's data sheet; the SFU
# (sqrt, reciprocal, exp, log, sin, cos) at 16 per SM per clock x 132 SMs
# x 1.98 GHz; INT32 at half the FP32 rate.
FP32_PEAK = 67e12
INT32_PEAK = 33.5e12
SFU_PEAK = 16 * 132 * 1.98e9
HBM_PEAK = 3.35e12
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


def reset_launches():
    for mod in kernel_modules():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def read_launches() -> dict:
    out = {}
    for mod in kernel_modules():
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
    """K4 and K2 as an earlier tree built them: its csrc/culled.cu and
    csrc/pathtrace_bwd.cu (a `git archive` of that commit unpacked under
    the gitignored build/), compiled with this tree's nvcc flags and bound
    through this tree's wrappers (the C signatures of `culled_occluded` and
    `pathtrace_backward` have not changed), so that old and new kernels are
    timed in turns in one run. (The parent's culled.cu carries its K3 too,
    the same code as this tree's.)"""

    def __init__(self, csrc):
        import ctypes

        from skele_raytracer_tpu_torch.ops.cuda import _build

        out = os.path.join(REPO, "build", "parent_kernels")
        os.makedirs(out, exist_ok=True)
        procs = {name: subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
             os.path.join(out, f"{name}.so"),
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name in ("culled", "pathtrace_bwd")}
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            check(proc.returncode == 0,
                  f"parent {name}.cu build failed:\n{err}")
            for line in ptxas_summary(err):
                print(f"[ptxas] parent {name}: {line}")
        pt, culled, _, _ = kernel_modules()
        self.libs = {
            (culled, "_lib"): culled.bind(
                ctypes.CDLL(os.path.join(out, "culled.so"))),
            (pt, "_bwd_lib"): pt.bind_backward(
                ctypes.CDLL(os.path.join(out, "pathtrace_bwd.so")))}
        print(f"[build] the parent tree's culled.cu and pathtrace_bwd.cu "
              f"from {csrc}")

    def call(self, mod, fn):
        """fn() with `mod`'s wrappers launching the parent's library (K4's
        for ops/cuda/culled.py, K2's for ops/cuda/pathtrace.py)."""
        attr = "_bwd_lib" if (mod, "_bwd_lib") in self.libs else "_lib"
        saved = getattr(mod, attr)
        setattr(mod, attr, self.libs[mod, attr])
        try:
            return fn()
        finally:
            setattr(mod, attr, saved)


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
    kernel of a tenth of a millisecond does not hide."""
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
    check(False, f"profiled {', '.join(missed)}, want {reps}")


def time_redesigned(name, label, n, smi, kernel, tag, plain, work, parent,
                    mod, parent_tag, equal, lanes_for=None):
    """A redesigned kernel (K3, K4 or K7) alone at one wave of n rays.
    `kernel(lanes)` launches it with that many lanes per ray (None: the
    launcher's choice), whose kernel is named `tag(lanes)`. Prints its
    device time per launch (`device_ms`) at each lane count of
    culled.LANES (`[tune]`) and, with `parent`, the parent tree's kernel's
    (named `parent_tag`) on the same inputs in the same turns (their
    outputs must agree: `equal(new, old)`); the time of one wrapper call
    by CUDA events, in turns with the parent's; the plain version's; the
    bound and the shares of it. Returns (device ms at the launcher's
    choice, plain_ms, bound_ms, bound_by, the parent's device ms or
    None). `lanes_for`: the launcher's rule (culled.lanes_for by
    default)."""
    _, culled, _, _ = kernel_modules()
    lanes_for = lanes_for or culled.lanes_for
    # the launcher's own lane count through the launcher's entry
    fns = {tag(g): (lambda g=g: kernel(None if g == lanes_for(n) else g))
           for g in culled.LANES}
    calls = [lambda: kernel(None)]
    if parent is not None:
        check(equal(kernel(None), parent.call(mod, lambda: kernel(None))),
              f"{name} {label}: the parent tree's kernel disagrees")
        fns[parent_tag] = lambda: parent.call(mod, lambda: kernel(None))
        calls.append(fns[parent_tag])
    dev = device_ms(fns)
    call_ms = turns_ms(calls)
    ms = dev[tag(lanes_for(n))]
    old_ms = dev.get(parent_tag)
    plain_ms = median_ms(plain, 3)
    b_ms, b_by = work
    old_txt = ("" if old_ms is None else
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
          + ", ".join(f"{g}: {dev[tag(g)]:.4f}" for g in culled.LANES)
          + f" (the launcher picks {lanes_for(n)})")
    return ms, plain_ms, b_ms, b_by, old_ms


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work, from
# operations counted per sample or per ray-triangle pair (an estimate of
# what the kernel computes on these inputs; the chip machine has no
# hardware counters) and the bytes it must move.


def roofline(fp32=0.0, sfu=0.0, int32=0.0, nbytes=0.0):
    """(bound_ms, bound_by): the larger of the operations' time, each type
    at its peak, and the bytes' time at HBM's rate."""
    ops_s = max(fp32 / FP32_PEAK, sfu / SFU_PEAK, int32 / INT32_PEAK)
    mem_s = nbytes / HBM_PEAK
    return max(ops_s, mem_s) * 1e3, ("operations" if ops_s >= mem_s
                                     else "bytes")


def _w(f=0, s=0, i=0):
    return np.array([f, s, i], np.float64)  # fp32, sfu, int32 operations


def k1_sample_work(st, replay=False):
    """Operations of one sample of K1 (or, with replay, of one replay
    forward of K2): [fp32, sfu, int32]. Scans count every table row;
    shadow scans are counted whole (they may exit at the first occluder);
    the replay has no scans (the recorded primitive's t instead)."""
    S, T = st["S"] * st["sph_on"], st["T"] * st["tri_on"]
    norm_dirs = not st["quirks"].unnormalized_ray_dirs
    draw = _w(i=70)  # one threefry2x32 call
    scan = _w(20 * S + 40 * T, S + T)
    hit_t = _w(30, 2) if replay else scan
    lights_on = st["point_on"] or st["dir_on"]
    shade = _w(3)
    if lights_on:
        occl = scan if st["use_shadows"] and not replay else _w()
        shade = shade + _w(12, 2)
        if st["point_on"]:
            per = _w(40, 6) + occl
            if st["F"]:
                per = _w(20, 3) + occl + st["F"] * (4 * draw + _w(50, 2))
            shade = shade + st["L"] * per
        if st["dir_on"]:
            shade = shade + st["LD"] * (_w(30, 4) + occl)
    geo = _w(25, 2)
    w = _w(20) + (_w(10, 2) if norm_dirs else 0) + (draw if st["grid"] else 0)
    w = w + hit_t + geo + shade + _w(10, 1)
    if st["mc"] and st["D"] > 1:
        w = w + _w(15, 4)
        for b in range(1, st["D"]):
            last = b == st["D"] - 1
            w = w + st["P"] * (draw + _w(26, 4) + (_w(10, 2) if norm_dirs
                                                   else 0) + hit_t + _w(12, 1)
                               + (geo if lights_on or not last else 0)
                               + (shade if lights_on else _w(3))
                               + (_w(15, 4) if not last else 0))
    return w


def k1_work(st, n, records=False):
    """(bound_ms, bound_by) of K1 over n samples."""
    f, sfu, i = k1_sample_work(st) * n
    tables = 4 * (st["S"] * 16 + st["T"] * 24 + (1 + st["F"]) * 24
                  + (st["L"] + st["LD"]) * 8)
    K = 1 + (st["P"] * (st["D"] - 1) if st["mc"] and st["D"] > 1 else 0)
    nbytes = n * (20 + 12 + (4 * K if records else 0)) + tables
    return roofline(f, sfu, i, nbytes)


def k2_work(st, n):
    """(bound_ms, bound_by) of K2 over n samples: per sample the replay
    forward, the recompute of each path's earlier bounces (D(D-1)/2 per
    path) and an adjoint of about twice the replay's operations, plus the
    warp reductions (a staged row per record, a shuffle tree per light and
    misc value)."""
    fwd = k1_sample_work(st, replay=True)
    D, P = st["D"], st["P"]
    recompute = (P * (D - 1) * (D - 2) // 2 if st["mc"] and D > 2 else 0)
    per_bounce = fwd / max(1 + (P * (D - 1) if st["mc"] and D > 1 else 0), 1)
    K = 1 + (P * (D - 1) if st["mc"] and D > 1 else 0)
    lights = (st["L"] * st["point_on"] + st["LD"] * st["dir_on"])
    reduce_ops = K * (32 + lights * 7 * 5) + 28 * 5
    f, sfu, i = (3 * fwd + recompute * per_bounce + _w(reduce_ops)) * n
    E = (st["S"] * 16 + st["T"] * 24 + (1 + st["F"]) * 24
         + (st["L"] + st["LD"]) * 8)
    blocks = min(-(-n // 128), 1024)
    nbytes = n * (20 + 4 * K + 12) + 4 * E * (1 + 2 * blocks + 1)
    return roofline(f, sfu, i, nbytes)


def mesh_work(o, d, mesh, quirks, live=None):
    """(bound_ms, bound_by) of K3 on a wave: each live ray slab-tests every
    cluster box, then tests the triangles of the clusters whose (widened)
    box it enters."""
    from skele_raytracer_tpu_torch.ops import accel

    parity = quirks.reference_triangle_test
    lo, hi, _ = mesh.kernel_boxes(mirrored=parity)
    lv = (torch.ones(o.shape[0], device=o.device) if live is None
          else (live > 0).float())
    C = mesh.n_clusters
    per_cluster = (mesh.mask.reshape(C, -1) > 0).sum(1).float()
    pairs = 0.0
    for i in range(0, o.shape[0], 8192):
        m = accel.ray_aabb_mask(o[i:i + 8192], d[i:i + 8192], lo, hi,
                                allow_negative=parity).float()
        pairs += float(((m @ per_cluster) * lv[i:i + 8192]).sum())
    rays = float(lv.sum())
    nbytes = o.shape[0] * (40 + 8 + 8) + float(mesh.rec.numel()) * 4
    return roofline(rays * C * 20 + pairs * 40, rays * 3 + pairs, 0, nbytes)


def occluded_work(o, d, mesh, quirks, live=None, t_max=None, chunk=4096):
    """(bound_ms, bound_by) of K4 on a wave, from what this wave's data
    needs: each live ray slab-tests every cluster box, then tests the
    triangles of the clusters its shadow ray enters before its bound, front
    to back, up to and including the first cluster that holds an occluder
    (an any-hit test stops there; ~40 FP32 operations per pair, no
    division)."""
    from skele_raytracer_tpu_torch.config import CLEAN_T_EPS
    from skele_raytracer_tpu_torch.ops import accel
    from skele_raytracer_tpu_torch.ops.cuda import culled

    parity = quirks.reference_triangle_test
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    lo, hi, _ = mesh.kernel_boxes(mirrored=parity)
    C = mesh.n_clusters
    per_cluster = (mesh.mask.reshape(C, -1) > 0).sum(1).float()
    rec = mesh.rec.reshape(-1, 20)
    bound = (torch.full((o.shape[0],), culled.BIG, device=o.device)
             if t_max is None else t_max)
    idx = (torch.arange(o.shape[0], device=o.device) if live is None
           else (live > 0).nonzero().flatten())
    pairs = 0.0
    for i in range(0, idx.numel(), chunk):
        k = idx[i:i + chunk]
        m, tmin = accel.ray_aabb_entry(o[k], d[k], lo, hi, t_clip=t_clip)
        m = m & (tmin < bound[k, None])
        feats = culled._ray_features10(o[k], d[k])
        occ = culled._occludes(*culled.planes_torch(
            feats, rec, 1.0 if parity else -1.0), t_clip, bound[k])
        occ = occ.reshape(k.numel(), C, -1).any(-1) & m
        first = torch.where(occ, tmin, float("inf")).amin(1, keepdim=True)
        pairs += float(((m & (tmin <= first)).float() @ per_cluster).sum())
    rays = float(idx.numel())
    nbytes = o.shape[0] * (40 + 4 + 4 + 4) + float(mesh.rec.numel()) * 4
    return roofline(rays * C * 20 + pairs * 40, rays * 3, 0, nbytes)


def k5_work(n_rays, n_tris):
    """(bound_ms, bound_by) of K5: every (ray, triangle) pair."""
    pairs = float(n_rays) * n_tris
    return roofline(pairs * 40, pairs, 0, n_rays * (36 + 20) + n_tris * 9 * 16)


def k6_work(n_rays, n_sph):
    """(bound_ms, bound_by) of K6: every (ray, sphere) pair, ~26 FP32
    operations, a square root and a division each, and the ray's three dot
    products."""
    pairs = float(n_rays) * n_sph
    return roofline(pairs * 26 + n_rays * 15.0, pairs * 2, 0,
                    n_rays * (24 + 8) + n_sph * 20)


def fused_work(o, d, scene, outs, use_shadows, live=None, chunk=4096):
    """(bound_ms, bound_by) of K7 on a wave, from what this wave's data
    needs: each live ray slab-tests every cluster box and tests the
    triangles of the clusters it enters up to its hit (entry <= its t),
    scans every sphere, shades; per unmasked light with shadows, each ray
    that hit slab-tests every box and tests the triangles of the clusters
    its shadow ray enters before the bound, up to the first cluster that
    holds an occluder; every ray scans the spheres once more per light.
    `outs`: the wave's fused_shade_forward outputs."""
    from skele_raytracer_tpu_torch.ops import accel
    from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from skele_raytracer_tpu_torch.ops.geometry import (
        cross,
        hit_geometry,
        offset_origin,
    )

    mesh = scene.clusters
    lo, hi, _ = mesh.kernel_boxes(mirrored=False)
    C = mesh.n_clusters
    per_cluster = (mesh.mask.reshape(C, -1) > 0).sum(1).float()
    rec = mesh.rec.reshape(-1, 20)
    _, t, kind, index, _ = outs
    lv = (torch.ones(o.shape[0], device=o.device, dtype=torch.bool)
          if live is None else live > 0)
    rays = float(lv.sum())
    hit = lv & (kind > 0)
    t_hit = torch.where(torch.isfinite(t), t, 3.0e38)
    point, normal = hit_geometry(o, d, scene, kind, index, t)
    sh = offset_origin(point, normal)
    lights, n_point = mk.pack_lights(scene)
    S, L = scene.spheres.mask.shape[0], lights.shape[0]
    pairs, sh_tests, sh_pairs = 0.0, 0.0, 0.0
    for i in range(0, o.shape[0], chunk):
        sl = slice(i, i + chunk)
        m, tmin = accel.ray_aabb_entry(o[sl], d[sl], lo, hi)
        m = m & (tmin <= t_hit[sl, None]) & lv[sl, None]
        pairs += float((m.float() @ per_cluster).sum())
        if not use_shadows:
            continue
        for li in range(L):
            if float(lights[li, 6]) <= 0:
                continue
            h = hit[sl]
            if li < n_point:
                v = lights[li, None, 0:3] - point[sl]
                bound = torch.sqrt(torch.clamp((v * v).sum(1), min=1e-30))
                ldir = v / bound[:, None]
            else:
                ldir = lights[li, None, 0:3].expand(h.shape[0], 3)
                bound = torch.full_like(t_hit[sl], 3.0e38)
            so = sh[sl][h]
            ld, bd = ldir[h], bound[h]
            if so.shape[0] == 0:
                continue
            sh_tests += float(so.shape[0])
            m, tmin = accel.ray_aabb_entry(so, ld, lo, hi, t_clip=1e-4)
            m = m & (tmin < bd[:, None])
            f = torch.cat([ld, cross(so, ld), so,
                           torch.ones_like(bd)[:, None]], 1)
            occ = (mk._brute_t(*mk.planes_torch(f, rec, -1.0), True)[0]
                   < bd[:, None]).reshape(-1, C, rec.shape[0] // C).any(-1)
            first = torch.where(occ.any(1), occ.float().argmax(1), C)
            upto = torch.arange(C, device=o.device)[None, :] <= first[:, None]
            sh_pairs += float(((m & upto).float() @ per_cluster).sum())
    passes = 1 + (L if use_shadows else 0)
    fp32 = (rays * C * 20 + pairs * 40 + rays * S * 26 * passes
            + rays * (40 + 60 * L) + sh_tests * C * 20 + sh_pairs * 40)
    sfu = (rays * 3 + pairs + rays * S * 2 * passes + rays * (4 + 5 * L)
           + sh_tests * 3 + sh_pairs)
    nbytes = (o.shape[0] * (40 + 4 + 12 + 12 + 4 * L) + rec.numel() * 4
              + scene.triangles.mask.shape[0] * 56 + S * 64 + L * 28)
    return roofline(fp32, sfu, 0, nbytes)


# ---------------------------------------------------------------------------


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
    for mod in kernel_modules():
        mod.build_kernel()
    kernel_modules()[0].build_backward_kernel()
    kernel_modules()[1].build_sweep_kernel()
    dt = time.perf_counter() - t0
    each = ", ".join(f"{name} {sec:.2f} s" for name, sec in secs.items())
    print(f"[build] {', '.join(_build.CUDA_LIBRARIES)} from {_build.CSRC} "
          f"with nvcc {' '.join(_build.NVCC_FLAGS)}, in parallel: {each}; "
          f"{dt:.2f} s with load")
    for name, log in _build.build_logs.items():
        for line in ptxas_summary(log):
            print(f"[ptxas] {name}: {line}")


def ptxas_summary(log):
    """One line per kernel from `-Xptxas -v` output: registers, shared
    memory, stack and spills (ptxas prints the stack/spill line, then the
    register line, after each kernel's `Compiling entry function`), named
    by the kernel and its template arguments (nearest_kernel<8>,
    fused_kernel<4, true>)."""
    import re

    out, kernel, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                      r"(I(?:L[bi]\d+E)+E)?", line)
        if m:
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([bi])(\d+)E", m.group(2) or "")]
            kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            frame = ""
        elif kernel and "spill stores" in line:
            frame = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {frame}")
            kernel = None
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
              launches["triangle_nearest"] == 0,
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
    chunk 37 (`time_redesigned`; the parent tree's K3 is this tree's), K4
    at that chunk's bounce and primary shadow waves (`time_redesigned`:
    with the parent tree's K4 in turns), K5; and `render` end to end for
    dragon parity and clean gillum16."""
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig
    from skele_raytracer_tpu_torch.models.renderer import render
    from skele_raytracer_tpu_torch.ops.camera import rays_for_ids
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    _, culled, k5, _ = kernel_modules()
    times = {}

    def timed(name, wave, label, kernel, plain, work):
        ms = median_ms(kernel, 20)
        plain_ms = median_ms(plain, 3)
        times[name, wave] = (ms, plain_ms) + work
        print(f"[time] {name} {label} on {smi}: kernel {ms:.4f} ms, plain "
              f"PyTorch {plain_ms:.3f} ms (median of 20 and 3 warm runs); "
              f"bound {work[0]:.4f} ms by {work[1]}")

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
            occluded_work(o, d, mesh, CLEAN, live=live), parent, culled,
            "occluded_kernel", torch.equal, lambda n: culled.occluded_lanes())

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
    timed("triangle_nearest", "primary", f"700-triangle mesh primary chunk "
          f"({CHUNK_RAYS} rays)",
          lambda: k5.triangle_nearest_kernel(feats, rec, sign=-1.0,
                                             clip=True),
          lambda: k5.triangle_nearest_torch(feats, rec, sign=-1.0,
                                            clip=True),
          k5_work(CHUNK_RAYS, tr.v0.shape[0]))

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
    lane count (`time_k2`) and, with `parent`, the parent tree's K2 and a
    `train_step` through it in turns with this tree's. Returns the parity
    run's numbers."""
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
                static, smi, parent)
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


def time_k2(label, tabs, planes, rec, g, static, smi, parent):
    """K2 over the whole frame by CUDA events around one wrapper call: at
    each lane count of pt.BWD_LANES (`[tune]`, median of 5) and, with
    `parent`, the parent tree's K2 in turns with this tree's (median of 10
    each; their outputs within GRAD_RTOL of each other), each beside its
    share of the same bound (`k2_work`)."""
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
    if parent is None:
        return
    old = lambda: parent.call(pt, run)
    for name, a, b in zip(("sph", "tri", "misc", "pl", "dl"), run(), old()):
        scale = b.abs().max().item()
        check((a - b).abs().max().item() <= GRAD_RTOL * scale + GRAD_ATOL,
              f"{label}: this tree's and the parent tree's K2 disagree on "
              f"{name}")
    new_ms, old_ms = turns_ms([run, old])
    print(f"[time] pathtrace_bwd {label} ({n} samples) on {smi}: kernel "
          f"{new_ms:.4f} ms ({b_ms / new_ms:.2%} of the bound), the parent "
          f"tree's kernel {old_ms:.4f} ms ({b_ms / old_ms:.2%} of the "
          f"bound), {old_ms / new_ms:.2f}x (CUDA events around one call, "
          f"median of 10 each, in turns); bound {b_ms:.4f} ms by {b_by}")


def phase_k2_lights(smi, parent=None):
    """K2 at the most lights it takes, with shadows (22, the record bits)
    and without (32, its shared memory: pathtrace.MAX_REPLAY_LIGHTS), the
    last two KERNEL_CASES (checked there against the plain version) at
    1920x1080 clean gillum16: `time_k2`, with `parent` the parent tree's K2
    in turns."""
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
                static, smi, parent)


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
    this tree's and the parent tree's K2 in turns."""
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
              f"this tree's K2, {ms[1]:.3f} ms with the parent tree's (CUDA "
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
    of dragon's chunk 37 (`time_redesigned`). With `parent`, the split
    frame again with the parent tree's K4, in turns. Returns the launches,
    frame times and K7's timings."""
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
            ms = turns_ms([fused, split_frame,
                           lambda: parent.call(culled, split_frame)], reps=3)
            print(f"[fused] {label} {w}x{h} frames with this tree's and the "
                  f"parent tree's K4, in turns (median of 3 frames each) on "
                  f"{smi}: fused {ms[0]:.2f} ms, split {ms[1]:.2f} ms "
                  f"(parent's K4 {ms[2]:.2f} ms; K3 and K7 are the same "
                  f"kernels in both trees)")
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
            fused_work(o, d, scene, outs, True, live=live), None, mk, None,
            None)
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


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", help="an earlier tree's csrc/ whose K4 "
                    "and K2 are timed in turns with this tree's")
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    parent = ParentKernels(args.parent_csrc) if args.parent_csrc else None
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
    mesh_counts = phase_mesh_main_path()
    times = phase_mesh_timings(smi, parent)
    t0 = time.perf_counter()
    rec_err, k2_err = phase_k2_headline()
    phase_k2_lights(smi, parent)
    phase_train_routes()
    trained = phase_train_headline(smi, parent)
    phase_grad_mesh()
    print(f"[train] the training phases took {time.perf_counter() - t0:.1f} "
          f"s wall")
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
    # dominates it (the bounce wave); launches: that frame's CLI run
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

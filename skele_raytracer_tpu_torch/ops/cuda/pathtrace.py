"""Whole-frame path tracer for small (non-mesh) scenes: host side, plain
PyTorch version and the CUDA kernel's wrapper.

The counterpart of the JAX package's `ops/pallas/pathtrace.py`. One
kernel (csrc/pathtrace.cu, math in csrc/frame_math.cuh) renders the whole
frame: per flat sample id it generates the camera ray, draws threefry2x32
randoms in registers, scans the spheres (S <= 256) and decorative
triangles (T <= 32), shades Blinn-Phong with shadow scans and the fog
reroute (F <= 2), and runs all Monte-Carlo paths. The scene rides along as
five small float32 tables (`_pack_tables`) and the static configuration
as a POD struct (`_Params`).

`frame_math_torch` is the plain PyTorch version of that kernel: the
forward `_build_frame_math` of the JAX package transcribed onto flat [N]
tensors, with the same operation order. Sphere and triangle scans run
over an [N, S] / [N, T] axis at once; a first-min `argmin` over the
masked numerators is the sequential scan's strict-< first-wins update.

`pathtrace_forward` is the wrapper: for CPU tensors it runs the plain
version (that is what the tests compare with the JAX package); for CUDA
tensors it launches the kernel, or raises. It never falls back.

Gradients (the JAX package's custom_vjp `pathtrace_ids`): with
`records` the forward also writes one packed hit record per (sample,
bounce); the backward kernel K2 (csrc/pathtrace_bwd.cu, a hand-written
adjoint in csrc/frame_adjoint.cuh) replays each sample from its records
and returns the five table cotangents, and autograd maps them through
`_pack_tables` onto the scene's leaves (`_PathTrace`). The plain version
of K2 is `torch.autograd.grad` of `frame_math_torch`'s replay
(`replay_table_grads`). Where the records do not fit (`_can_replay`) the
gradient re-derives through the wavefront (`_WavefrontGrad`).
`_replay_radiance` is the independent oracle of the replay, written with
the wavefront's ops.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from skele_raytracer_tpu_torch.config import (
    CLEAN_T_EPS,
    INDIRECT_ORIGIN_EPS,
    SHADOW_ORIGIN_EPS,
    TRIANGLE_DET_EPS,
    RenderConfig,
)
from skele_raytracer_tpu_torch.ops.camera import fov_angle
from skele_raytracer_tpu_torch.ops.cuda._build import check_outputs
from skele_raytracer_tpu_torch.ops.geometry import cross, normalize
from skele_raytracer_tpu_torch.ops.sampling import (
    PURPOSE_FOG,
    PURPOSE_JITTER,
    PURPOSE_PATH,
    _GOLDEN,
    _MASK,
    bits_to_unit,
    tangent_frame,
    threefry2x32,
)
from skele_raytracer_tpu_torch.utils import profiling

MAX_SPHERES = 256
MAX_TRIS = 32
MAX_FOG = 2

_BIG = float(np.float32(3.0e38))  # stand-in for +inf
_PI = float(np.float32(np.pi))
_TWO_PI = float(np.float32(2.0 * np.pi))

# Launches of each kernel of this module, counted where the wrapper
# launches it (a CPU tensor, which runs the plain version, counts none).
# A "pathtrace_bwd" launch is K2's two stages: the per-block sums and
# their reduce.
LAUNCHES = {"pathtrace": 0, "pathtrace_records": 0, "pathtrace_bwd": 0}
profiling.COUNTERS["launches"]["pathtrace"] = LAUNCHES


def use_pathtrace(scene, cfg: RenderConfig) -> bool:
    """True when the whole-frame path tracer serves the config: a small
    scene (spheres + at most MAX_TRIS decorative triangles), the linear
    (MC / parity) integrator, at most MAX_FOG live fog volumes. The JAX
    package's gate (`use_pathtrace` there) without its backend test: in
    this package both backends run this path."""
    return (
        (scene.has_spheres or scene.has_triangles)
        and not (scene.has_triangles
                 and scene.triangles.mask.shape[0] > MAX_TRIS)
        and (not (scene.has_fog and not scene.fog_zeroed)
             or scene.fog.mask.shape[0] <= MAX_FOG)
        and (cfg.monte_carlo or cfg.quirks.disable_reflections)
        and scene.spheres.mask.shape[0] <= MAX_SPHERES
        and cfg.max_depth >= 1
    )


# Records need static path slots, an 8-bit sphere index and every padded
# light's unshadowed bit inside an int32 (the JAX package's
# `_UNROLL_PATHS` and `_UNROLL_SPHERES`).
MAX_REPLAY_PATHS = 32
MAX_REPLAY_SPHERES = 64
# Lights the backward kernel takes: it sums each light's gradient per
# thread in shared memory, 3.6 KiB a light (csrc/frame_adjoint.cuh
# `bwd_smem_floats`); at 32 lights and the largest tables above a block
# needs 176 KiB of the H100's 227 KiB. The JAX package has no such limit;
# with shadows the record bits allow 22 lights anyway.
MAX_REPLAY_LIGHTS = 32


def _n_records(cfg: RenderConfig) -> int:
    """Hit records per sample: primary + one per (path, bounce)."""
    if not cfg.monte_carlo or cfg.max_depth <= 1:
        return 1
    return 1 + cfg.paths_per_sample * (cfg.max_depth - 1)


def _can_replay(scene, cfg: RenderConfig) -> bool:
    """True when the records fit (the JAX package's `_can_replay`) and the
    backward kernel takes the lights (MAX_REPLAY_LIGHTS); else gradients
    re-derive through the wavefront (`pathtrace_ids`)."""
    L = scene.point_lights.mask.shape[0]
    LD = scene.directional_lights.mask.shape[0]
    return (
        cfg.paths_per_sample <= MAX_REPLAY_PATHS
        and scene.spheres.mask.shape[0] <= MAX_REPLAY_SPHERES
        and (not cfg.use_shadows or 10 + L + LD <= 32)
        and L + LD <= MAX_REPLAY_LIGHTS
    )


# ---------------------------------------------------------------------------
# Host side: tables, static arguments, sample planes
# ---------------------------------------------------------------------------


@profiling.spanned("k1.tables")
def _pack_tables(scene):
    """The five float32 tables the kernel reads (layouts in
    csrc/frame_math.cuh): spheres [S,16], triangles [T,24] (one zero row
    without triangles), misc [1+F,24] (camera row + live fog rows),
    point lights [L,8], directional lights [LD,8]."""
    sph_t, cam_t = scene.spheres, scene.camera
    S = sph_t.mask.shape[0]
    dev = sph_t.center.device
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    sph_tab = torch.cat([
        sph_t.center,                          # 0:3
        (sph_t.radius * sph_t.radius)[:, None],  # 3
        sph_t.mask[:, None],                   # 4
        sph_t.ambient,                         # 5:8
        sph_t.diffuse,                         # 8:11
        sph_t.specular,                        # 11:14
        sph_t.power[:, None],                  # 14
        zeros(S, 1),                           # 15 pad
    ], dim=1)
    if scene.has_triangles:
        tr = scene.triangles
        e1 = tr.v1 - tr.v0
        e2 = tr.v2 - tr.v0
        ntri = normalize(cross(e1, e2))
        tri_tab = torch.cat(
            [tr.v0, e1, e2, tr.mask[:, None], ntri, tr.ambient, tr.diffuse,
             tr.specular, tr.power[:, None], zeros(tr.mask.shape[0], 1)],
            dim=1)
    else:
        tri_tab = zeros(1, 24)

    right = cross(-cam_t.direction, cam_t.up)
    misc = torch.cat([cam_t.position, right, cam_t.up, cam_t.direction,
                      scene.ambient, scene.background, zeros(6)])[None, :]
    if scene.has_fog and not scene.fog_zeroed:
        fg = scene.fog
        Fn = fg.mask.shape[0]
        misc = torch.cat([misc, torch.cat(
            [fg.radius[:, None], fg.absorption[:, None],
             fg.scattering[:, None], fg.albedo, fg.mask[:, None],
             zeros(Fn, misc.shape[1] - 7)], dim=1)], dim=0)

    plt = scene.point_lights
    L = plt.mask.shape[0]
    pl_tab = torch.cat([plt.position, plt.colour, plt.mask[:, None],
                        zeros(L, 1)], dim=1)
    dlt = scene.directional_lights
    LD = dlt.mask.shape[0]
    dl_tab = torch.cat([normalize(dlt.direction), dlt.colour,
                        dlt.mask[:, None], zeros(LD, 1)], dim=1)
    return tuple(t.contiguous()
                 for t in (sph_tab, tri_tab, misc, pl_tab, dl_tab))


def _static_kernel_args(scene, cfg: RenderConfig) -> dict:
    """The static configuration of the kernel (the JAX package's
    `_static_kernel_args`)."""
    # Parity's zeroed fog reroutes (and so kills) the whole point-light
    # block, as ops/shading.direct_illumination does.
    point_on = scene.has_point_lights and not (
        scene.has_fog and scene.fog_zeroed)
    return dict(
        S=scene.spheres.mask.shape[0],
        T=scene.triangles.mask.shape[0] if scene.has_triangles else 1,
        L=scene.point_lights.mask.shape[0],
        LD=scene.directional_lights.mask.shape[0],
        sph_on=scene.has_spheres, tri_on=scene.has_triangles,
        point_on=point_on, dir_on=scene.has_directional,
        use_shadows=cfg.use_shadows, mc=cfg.monte_carlo,
        P=cfg.paths_per_sample, D=cfg.max_depth, grid=cfg.grid_size,
        width=cfg.width, height=cfg.height, angle=fov_angle(cfg),
        quirks=cfg.quirks,
        F=(scene.fog.mask.shape[0]
           if scene.has_fog and not scene.fog_zeroed else 0),
    )


@profiling.spanned("k1.planes")
def _plane_inputs(cfg: RenderConfig, sample_ids: torch.Tensor):
    """Per-sample planes (ids, xs, ys, cj, ci), flat [N]: the pixel
    column/row and the stratified jitter cell, in float32 from the uint32
    ids exactly as the JAX package computes them (no tile padding: the
    kernel bounds-checks instead)."""
    ids = sample_ids.to(torch.int64) & _MASK
    spp = cfg.samples_per_pixel
    pixel = (ids // spp).to(torch.float32)
    sample = (ids % spp).to(torch.float32)
    xs = torch.fmod(pixel, cfg.width)
    ys = torch.floor(pixel / cfg.width)
    if cfg.grid_size > 0 and not cfg.quirks.diagonal_jitter:
        ci = torch.floor(sample / cfg.grid_size)
        cj = torch.fmod(sample, cfg.grid_size)
    else:
        ci = cj = torch.zeros_like(sample)
    return ids, xs, ys, cj, ci


# ---------------------------------------------------------------------------
# The plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def _draw2(seed, bounce: int, purpose: int, ids, pair_idx: int):
    """Draws (2*pair_idx, 2*pair_idx + 1) of the (seed, bounce, purpose)
    stream: both words of one threefry2x32 call."""
    k1 = (int(bounce) * _GOLDEN + int(purpose)) & _MASK
    y0, y1 = threefry2x32(seed, k1, ids, pair_idx)
    return bits_to_unit(y0), bits_to_unit(y1)


def _pos_sqrt(x):
    """sqrt(where(x > 0, x, 1)) * (x > 0)."""
    pos = x > 0
    return torch.sqrt(torch.where(pos, x, 1.0)) * pos


def _normalize3(vx, vy, vz):
    """geometry.normalize on component planes (zero maps to zero)."""
    return normalize(torch.stack((vx, vy, vz), dim=-1)).unbind(-1)


def _max(x, c: float):
    """jnp.maximum(x, c) for a constant c (NaN propagates)."""
    return torch.clamp(x, min=c)


def _tangent_frame(nx, ny, nz):
    """sampling.tangent_frame on component planes."""
    pn, pb = tangent_frame(torch.stack((nx, ny, nz), dim=-1))
    return pn.unbind(-1), pb.unbind(-1)


def _col(v):
    """A per-ray plane as an [N, 1] column (scalars stay scalars)."""
    return v[:, None] if v.dim() == 1 else v


def _mt_t(o, d, v0, e1, e2):
    """Moller-Trumbore t of rays (o, d) against one triangle per ray
    (component planes): the replay's t of the recorded triangle."""
    dx, dy, dz = d
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    return (e2x * qx + e2y * qy + e2z * qz) * inv


def _first_min(vals):
    """(hit, best, idx) of the sequential strict-< scan over the last axis
    of `vals` ([N, K], misses already at _BIG): the first index of the
    minimum; rays with no value below _BIG keep index 0 and _BIG."""
    idx = torch.argmin(vals, dim=1)
    best = torch.gather(vals, 1, idx[:, None])[:, 0]
    hit = best < _BIG
    return hit, torch.where(hit, best, _BIG), torch.where(hit, idx, 0)


def _pack_record(idx, hit, tri_wins, bits):
    """The packed hit record: index bits 0:8, hit bit 8, triangle-won bit
    9, the per-light unshadowed bits from bit 10 (int64, uint32 value)."""
    rec = idx.to(torch.int64) | (hit.to(torch.int64) << 8)
    if tri_wins is not None:
        rec = rec | (tri_wins.to(torch.int64) << 9)
    return rec if bits is None else rec | bits


def _as_int32(x):
    """int64 tensor of uint32 values -> int32 with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def frame_math_torch(tabs, planes, seed, *, S, T, L, LD, sph_on, tri_on,
                     point_on, dir_on, use_shadows, mc, P, D, grid, width,
                     height, angle, quirks, F=0, emit_records=False,
                     recs_in=None):
    """Radiance planes (r, g, b), each [N] float32, for the sample planes
    of `_plane_inputs`: the forward of the JAX package's
    `_build_frame_math` on flat tensors (see the module docstring).
    `tabs` are `_pack_tables`' five tables, on the planes' device.

    The two modes of `_build_frame_math`:

    * `emit_records`: also return the [K, N] int32 hit records
      (`_pack_record`, K = `_n_records`), one per (sample, bounce): slot 0
      the primary hit, slot 1 + p * (D - 1) + (b - 1) path p's bounce b.
    * `recs_in` ([K, N] integer records): the replay. Each nearest-hit scan
      collapses to the recorded primitive's t (its quadratic or its
      Moller-Trumbore t, both differentiable in the tables) and each
      occlusion scan to its record bit; the fog draws are recomputed from
      the RNG. `torch.autograd.grad` of the replay with respect to the
      tables is the plain version of the backward kernel K2.
    """
    if emit_records and recs_in is not None:
        raise ValueError("emit_records and recs_in are exclusive")
    replay = recs_in is not None
    if replay:
        recs_in = recs_in.to(torch.int64) & _MASK
    recs_out = [None] * _static_n_records(dict(mc=mc, P=P, D=D))
    sph_tab, tri_tab, misc, pl_tab, dl_tab = tabs
    ids, xs, ys, cj, ci = planes
    seed = int(seed) & _MASK
    N = ids.shape[0]
    dev = xs.device

    aspect = width / float(height)
    inv_w, inv_h = 1.0 / width, 1.0 / height
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    clip2 = float(np.float32(2.0 * t_clip))
    clean_offsets = not quirks.scalar_epsilon_offset
    shadow_bound = not quirks.near_clip_t_le_1
    ref_test = quirks.reference_triangle_test
    tri_black = quirks.triangles_shade_black
    shadow_tris = tri_on and not quirks.sphere_only_shadows
    lights_on = point_on or dir_on

    cam = tuple(misc[0, c] for c in range(0, 3))
    right = tuple(misc[0, c] for c in range(3, 6))
    up = tuple(misc[0, c] for c in range(6, 9))
    cdir = tuple(misc[0, c] for c in range(9, 12))
    amb_s = tuple(misc[0, c] for c in range(12, 15))
    bg = tuple(misc[0, c] for c in range(15, 18))

    # sphere table columns as [1, S] rows
    srow = lambda c: sph_tab[None, :S, c]
    s_cx, s_cy, s_cz, s_r2 = srow(0), srow(1), srow(2), srow(3)
    s_live = srow(4) > 0
    trow = lambda c: tri_tab[None, :T, c]
    t_v0 = (trow(0), trow(1), trow(2))
    t_e1 = (trow(3), trow(4), trow(5))
    t_e2 = (trow(6), trow(7), trow(8))
    t_live = trow(9) > 0

    def sphere_nums(o, d, a4, clipnum):
        """[N, S] numerators -b - sqrt(disc) and their validity."""
        dx, dy, dz = (_col(v) for v in d)
        ex, ey, ez = _col(o[0]) - s_cx, _col(o[1]) - s_cy, _col(o[2]) - s_cz
        b = 2.0 * (dx * ex + dy * ey + dz * ez)
        c = ex * ex + ey * ey + ez * ez - s_r2
        disc = b * b - _col(a4) * c
        num = -b - _pos_sqrt(disc)
        valid = (disc >= 0) & (num > _col(clipnum)) & s_live
        return num, valid

    def tri_test(o, d):
        """[N, T] Moller-Trumbore validity and t (csrc tri_test)."""
        dx, dy, dz = (_col(v) for v in d)
        v0x, v0y, v0z = t_v0
        e1x, e1y, e1z = t_e1
        e2x, e2y, e2z = t_e2
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = torch.abs(det) >= TRIANGLE_DET_EPS
        inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
        tvx, tvy, tvz = _col(o[0]) - v0x, _col(o[1]) - v0y, _col(o[2]) - v0z
        u_dot = tvx * px + tvy * py + tvz * pz
        u = (-u_dot if ref_test else u_dot) * inv
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        valid = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & t_live
        if not ref_test:
            valid = valid & (t > CLEAN_T_EPS)
        return valid, t

    def nearest_replay(slot, o, d):
        """The recorded hit of `slot`: only the recorded primitive's t is
        recomputed (the JAX package's replay branch of `nearest`)."""
        rec = recs_in[slot]
        hit_any = ((rec >> 8) & 1) > 0
        idx = rec & 0xFF
        dx, dy, dz = d
        tri_wins = ((rec >> 9) & 1) > 0 if tri_on else None
        sph_sel = hit_any & ~tri_wins if tri_on else hit_any
        if sph_on:
            cx, cy, cz, r2 = gather_rows(sph_tab, idx, (0, 1, 2, 3), S,
                                         valid=sph_sel)
            a = dx * dx + dy * dy + dz * dz
            a = torch.where(a > 0, a, 1.0)  # dead rays never hit
            ex, ey, ez = o[0] - cx, o[1] - cy, o[2] - cz
            b = 2.0 * (dx * ex + dy * ey + dz * ez)
            c = ex * ex + ey * ey + ez * ez - r2
            disc = b * b - 4.0 * a * c
            t_sph = (-b - _pos_sqrt(disc)) * (0.5 / a)
        else:
            t_sph = torch.zeros(N, dtype=torch.float32, device=dev)
        if tri_on:
            tri9 = gather_rows(tri_tab, idx, range(9), T, valid=tri_wins)
            t_tri = _mt_t(o, d, tri9[0:3], tri9[3:6], tri9[6:9])
            t_sel = torch.where(tri_wins, t_tri,
                                torch.where(sph_sel, t_sph, 0.0))
        else:
            t_sel = torch.where(hit_any, t_sph, 0.0)
        shades = sph_sel if (tri_on and tri_black) else hit_any
        return hit_any, tri_wins, t_sel, idx, shades

    def nearest(o, d, slot):
        """(hit_any, tri_wins, t, idx, shades) of the combined scan."""
        if replay:
            return nearest_replay(slot, o, d)
        dx, dy, dz = d
        if sph_on:
            a = dx * dx + dy * dy + dz * dz
            num, valid = sphere_nums(o, d, 4.0 * a, clip2 * a)
            s_hit, best, s_idx = _first_min(torch.where(valid, num, _BIG))
            s_t = best * (0.5 / a)
        else:
            s_hit = torch.zeros(N, dtype=torch.bool, device=dev)
            s_t = torch.full((N,), _BIG, dtype=torch.float32, device=dev)
            s_idx = torch.zeros(N, dtype=torch.int64, device=dev)
        if not tri_on:
            return s_hit, None, s_t, s_idx, s_hit
        valid, t = tri_test(o, d)
        t_hit, t_t, t_idx = _first_min(torch.where(valid, t, _BIG))
        tri_wins = t_hit & (t_t < torch.where(s_hit, s_t, _BIG))
        hit_any = s_hit | tri_wins
        t_sel = torch.where(tri_wins, t_t, s_t)
        idx = torch.where(tri_wins, t_idx, s_idx)
        shades = (s_hit & ~tri_wins) if tri_black else hit_any
        return hit_any, tri_wins, t_sel, idx, shades

    def occluded(o, d, bound):
        dx, dy, dz = d
        a = dx * dx + dy * dy + dz * dz
        a = torch.where(a > 0, a, 1.0)  # zero-length dirs never hit
        occ = torch.zeros(N, dtype=torch.bool, device=dev)
        if sph_on:
            num, valid = sphere_nums(o, d, 4.0 * a, clip2 * a)
            if bound is not None:
                valid = valid & (num * _col(0.5 / a) < _col(bound))
            occ = valid.any(dim=1)
        if shadow_tris:
            valid, t = tri_test(o, d)
            if bound is not None:
                valid = valid & (t < _col(bound))
            occ = occ | valid.any(dim=1)
        return occ

    def gather_rows(tab, idx, cols, n_rows, valid=None):
        """tab[idx, cols] as planes; indices past the table (and rays
        where `valid` is false) read 0."""
        inside = idx < n_rows
        if valid is not None:
            inside = inside & valid
        rows = tab[torch.clamp(idx, max=n_rows - 1)]
        return [torch.where(inside, rows[:, c], 0.0) for c in cols]

    def gather_mat(idx, tri_wins):
        """Material planes amb(3) dif(3) spec(3) power and the sphere
        center: parity reads the SPHERE table at the combined index; clean
        reads the triangle table where the triangle won."""
        m = gather_rows(sph_tab, idx, list(range(5, 15)) + [0, 1, 2], S)
        if tri_on and not tri_black:
            mt = gather_rows(tri_tab, idx, range(13, 23), T)
            m = [torch.where(tri_wins, b, a) for a, b in zip(m[:10], mt)] + [
                torch.where(tri_wins, 0.0, c) for c in m[10:]]
        return dict(amb=m[0:3], dif=m[3:6], spec=m[6:9], power=m[9],
                    cen=m[10:13])

    def hit_geom(o, d, t, hit_any, tri_wins, idx, cen):
        tsafe = torch.where(hit_any, t, 0.0)
        px = o[0] + d[0] * tsafe
        py = o[1] + d[1] * tsafe
        pz = o[2] + d[2] * tsafe
        nx, ny, nz = _normalize3(px - cen[0], py - cen[1], pz - cen[2])
        if tri_on:
            tn = gather_rows(tri_tab, torch.where(tri_wins, idx, 0),
                             (10, 11, 12), T)
            flip = torch.where(tn[0] * d[0] + tn[1] * d[1] + tn[2] * d[2] > 0,
                               -1.0, 1.0)
            nx = torch.where(tri_wins, tn[0] * flip, nx)
            ny = torch.where(tri_wins, tn[1] * flip, ny)
            nz = torch.where(tri_wins, tn[2] * flip, nz)
        return (px, py, pz), (nx, ny, nz)

    def fog_point(tri_wins, x, cen):
        if F > 0 and tri_on and not tri_black:
            return tuple(torch.where(tri_wins, x[c], cen[c]) for c in range(3))
        return cen

    def spec_pow(n, view, ld, powr):
        hx, hy, hz = view[0] + ld[0], view[1] + ld[1], view[2] + ld[2]
        hn = _max(_pos_sqrt(hx * hx + hy * hy + hz * hz), 1e-30)
        ihn = 1.0 / hn
        ndoth = _max(n[0] * hx * ihn + n[1] * hy * ihn + n[2] * hz * ihn, 0.0)
        return torch.pow(_max(ndoth, 1e-30), powr) * (ndoth > 0)

    def shade(x, n, m, pc, idp, bounce, slot):
        """Ambient + per-light Blinn-Phong (+ shadows, + fog reroute).
        Returns (dr, dg, db, unshadowed record bits or None)."""
        amb, dif, spec, powr = m["amb"], m["dif"], m["spec"], m["power"]
        dr = amb_s[0] * amb[0]
        dg = amb_s[1] * amb[1]
        db = amb_s[2] * amb[2]
        bits = []
        if not lights_on:
            return dr, dg, db, None

        def gate_of(lm, bit, occ_fn):
            """mask * unshadowed: the record bit in the replay, else the
            shadow scan (whose bit is recorded with emit_records)."""
            if not use_shadows:
                return lm * torch.ones_like(x[0])
            if replay:
                unsh = (recs_in[slot] >> bit) & 1
            else:
                unsh = (~occ_fn()).to(torch.int64)
                if emit_records:
                    bits.append(unsh << bit)
            return lm * unsh.to(torch.float32)

        view = _normalize3(cam[0] - x[0], cam[1] - x[1], cam[2] - x[2])
        if use_shadows and not replay:
            if clean_offsets:
                xn = torch.sqrt(_max(x[0] * x[0] + x[1] * x[1] + x[2] * x[2],
                                     0.0))
                sc = CLEAN_T_EPS * (1.0 + xn)
                sh_o = (x[0] + sc * n[0], x[1] + sc * n[1], x[2] + sc * n[2])
            else:
                sh_o = (x[0] + SHADOW_ORIGIN_EPS, x[1] + SHADOW_ORIGIN_EPS,
                        x[2] + SHADOW_ORIGIN_EPS)
        for li in range(L if point_on else 0):
            lx, ly, lz, cr, cg, cb, lm = (pl_tab[li, c] for c in range(7))
            lvx, lvy, lvz = lx - x[0], ly - x[1], lz - x[2]
            d_l = _pos_sqrt(lvx * lvx + lvy * lvy + lvz * lvz)
            inv_dl = 1.0 / _max(d_l, 1e-30)
            ld = (lvx * inv_dl, lvy * inv_dl, lvz * inv_dl)
            gate = gate_of(lm, 10 + li, lambda: occluded(
                sh_o, _normalize3(lvx, lvy, lvz),
                d_l if shadow_bound else None))
            intensity = 1.0 / _max(d_l * d_l, 1e-30)
            ndotl = _max(n[0] * ld[0] + n[1] * ld[1] + n[2] * ld[2], 0.0)
            if F > 0:
                diff_base = intensity * ndotl
                fr = fg = fb = torch.zeros_like(d_l)
                for fi in range(F):
                    rad, absn, scat, alr, alg, alb, mf = (
                        misc[1 + fi, c] for c in range(7))
                    dcx, dcy, dcz = pc[0] - lx, pc[1] - ly, pc[2] - lz
                    dist = torch.sqrt(_max(dcx * dcx + dcy * dcy + dcz * dcz,
                                           0.0))
                    dist = torch.minimum(dist, 2.0 * rad)
                    p_no = torch.exp(-dist * (absn + scat))
                    base_p = (li * F + fi) * 4
                    pairs = [_draw2(seed, bounce, PURPOSE_FOG, idp, base_p + k)
                             for k in range(4)]
                    for term in (0, 1):
                        interacts = pairs[0][term] > p_no
                        nlx = ld[0] + scat * (pairs[1][term] * 2.0 - 1.0)
                        nly = ld[1] + scat * (pairs[2][term] * 2.0 - 1.0)
                        nlz = ld[2] + scat * (pairs[3][term] * 2.0 - 1.0)
                        ndotl2 = _max(n[0] * nlx + n[1] * nly + n[2] * nlz,
                                      0.0)
                        fr = fr + torch.where(interacts, dif[0] * diff_base,
                                              alr * ndotl2) * mf
                        fg = fg + torch.where(interacts, dif[1] * diff_base,
                                              alg * ndotl2) * mf
                        fb = fb + torch.where(interacts, dif[2] * diff_base,
                                              alb * ndotl2) * mf
                dr = dr + cr * fr * gate
                dg = dg + cg * fg * gate
                db = db + cb * fb * gate
                continue
            spow = spec_pow(n, view, ld, powr)
            gi = gate * intensity
            dr = dr + (dif[0] * cr * ndotl + spec[0] * cr * spow) * gi
            dg = dg + (dif[1] * cg * ndotl + spec[1] * cg * spow) * gi
            db = db + (dif[2] * cb * ndotl + spec[2] * cb * spow) * gi
        for li in range(LD if dir_on else 0):
            ldx, ldy, ldz, cr, cg, cb, lm = (dl_tab[li, c] for c in range(7))
            ld = tuple(v.expand(N) for v in (ldx, ldy, ldz))
            gate = gate_of(lm, 10 + L + li, lambda: occluded(sh_o, ld, None))
            ndotl = _max(n[0] * ld[0] + n[1] * ld[1] + n[2] * ld[2], 0.0)
            spow = spec_pow(n, view, ld, powr)
            dr = dr + (dif[0] * cr * ndotl + spec[0] * cr * spow) * gate
            dg = dg + (dif[1] * cg * ndotl + spec[1] * cg * spow) * gate
            db = db + (dif[2] * cb * ndotl + spec[2] * cb * spow) * gate
        packed = None
        for b_l in bits:
            packed = b_l if packed is None else packed | b_l
        return dr, dg, db, packed

    # ---- camera rays ------------------------------------------------------
    if grid > 0:
        r0, r1j = _draw2(seed, 0, PURPOSE_JITTER, ids, 0)
        if quirks.diagonal_jitter:
            jx = jy = r0
        else:
            jx = (cj + r0) / grid
            jy = (ci + r1j) / grid
    else:
        jx = jy = 0.5
    u = (2.0 * ((xs + jx) * inv_w) - 1.0) * angle * aspect
    v = (1.0 - 2.0 * ((ys + jy) * inv_h)) * angle
    dx = cdir[0] + u * right[0] + v * up[0]
    dy = cdir[1] + u * right[1] + v * up[1]
    dz = cdir[2] + u * right[2] + v * up[2]
    if not quirks.unnormalized_ray_dirs:
        dx, dy, dz = _normalize3(dx, dy, dz)
    d0 = (dx, dy, dz)

    def done(r, g, b):
        if not emit_records:
            return r, g, b
        return r, g, b, _as_int32(torch.stack(recs_out))

    hit0, triw0, t0, idx0, shades0 = nearest(cam, d0, 0)
    m0 = gather_mat(idx0, triw0)
    x0, n0 = hit_geom(cam, d0, t0, hit0, triw0, idx0, m0["cen"])
    d0r, d0g, d0b, bits0 = shade(x0, n0, m0, fog_point(triw0, x0, m0["cen"]),
                                 ids, 0, 0)
    if emit_records:
        recs_out[0] = _pack_record(idx0, hit0, triw0, bits0)
    sf0 = shades0.to(torch.float32)
    mf0 = 1.0 - hit0.to(torch.float32)

    if not mc:
        return done(sf0 * d0r + mf0 * bg[0], sf0 * d0g + mf0 * bg[1],
                    sf0 * d0b + mf0 * bg[2])
    dif0 = m0["dif"]
    l0r = sf0 * (d0r / _PI * dif0[0]) + mf0 * bg[0]
    l0g = sf0 * (d0g / _PI * dif0[1]) + mf0 * bg[1]
    l0b = sf0 * (d0b / _PI * dif0[2]) + mf0 * bg[2]
    if D <= 1:
        return done(l0r, l0g, l0b)

    # ---- Monte-Carlo continuation paths -----------------------------------
    pn0, pb0 = _tangent_frame(*n0)
    base = (_TWO_PI * dif0[0] * sf0, _TWO_PI * dif0[1] * sf0,
            _TWO_PI * dif0[2] * sf0)

    def sample_dir(r1, r2, n, pn, pb):
        s_th = _pos_sqrt(1.0 - r1 * r1)
        phi = _TWO_PI * r2
        sx = s_th * torch.cos(phi)
        sy = r1
        sz = s_th * torch.sin(phi)
        third = (pn[0], pb[1], pb[2]) if quirks.buggy_tangent_frame else pn
        ddx = sx * pb[0] + sy * n[0] + sz * third[0]
        ddy = sx * pb[1] + sy * n[1] + sz * third[1]
        ddz = sx * pb[2] + sy * n[2] + sz * third[2]
        if not quirks.unnormalized_ray_dirs:
            ddx, ddy, ddz = _normalize3(ddx, ddy, ddz)
        return ddx, ddy, ddz

    def bounce_origin(x, n):
        if clean_offsets:
            xn = torch.sqrt(_max(x[0] * x[0] + x[1] * x[1] + x[2] * x[2],
                                 0.0))
            sc = CLEAN_T_EPS * (1.0 + xn)
            return (x[0] + sc * n[0], x[1] + sc * n[1], x[2] + sc * n[2])
        return (x[0] + INDIRECT_ORIGIN_EPS, x[1] + INDIRECT_ORIGIN_EPS,
                x[2] + INDIRECT_ORIGIN_EPS)

    ar = ag = ab = torch.zeros(N, dtype=torch.float32, device=dev)
    for p in range(P):
        idp = (ids * P + p) & _MASK
        xb, nb, pnb, pbb = x0, n0, pn0, pb0
        Tb = None
        difb, sfb = dif0, sf0
        for b in range(1, D):
            r1, r2 = _draw2(seed, b - 1, PURPOSE_PATH, idp, 0)
            db3 = sample_dir(r1, r2, nb, pnb, pbb)
            ob3 = bounce_origin(xb, nb)
            if Tb is None:
                Tb = (base[0] * r1, base[1] * r1, base[2] * r1)
            else:
                f = _TWO_PI * r1
                Tb = (Tb[0] * (f * difb[0]) * sfb,
                      Tb[1] * (f * difb[1]) * sfb,
                      Tb[2] * (f * difb[2]) * sfb)
            last = b == D - 1
            slot = 1 + p * (D - 1) + (b - 1)
            hitb, triwb, tb, idxb, shadesb = nearest(ob3, db3, slot)
            mb = gather_mat(idxb, triwb)
            if lights_on or not last:
                xb, nb = hit_geom(ob3, db3, tb, hitb, triwb, idxb, mb["cen"])
            bitsb = None
            if lights_on:
                dbr, dbg, dbb, bitsb = shade(
                    xb, nb, mb, fog_point(triwb, xb, mb["cen"]), idp, b, slot)
            else:
                dbr = amb_s[0] * mb["amb"][0]
                dbg = amb_s[1] * mb["amb"][1]
                dbb = amb_s[2] * mb["amb"][2]
            if emit_records:
                recs_out[slot] = _pack_record(idxb, hitb, triwb, bitsb)
            difb = mb["dif"]
            sfb = shadesb.to(torch.float32)
            mfb = 1.0 - hitb.to(torch.float32)
            ar = ar + Tb[0] * (sfb * (dbr / _PI * difb[0]) + mfb * bg[0])
            ag = ag + Tb[1] * (sfb * (dbg / _PI * difb[1]) + mfb * bg[1])
            ab = ab + Tb[2] * (sfb * (dbb / _PI * difb[2]) + mfb * bg[2])
            if not last:
                pnb, pbb = _tangent_frame(*nb)
    inv_p = float(np.float32(1.0 / P))
    return done(l0r + ar * inv_p, l0g + ag * inv_p, l0b + ab * inv_p)


# ---------------------------------------------------------------------------
# The independent replay oracle (the wavefront's ops, not the kernel's)
# ---------------------------------------------------------------------------


def replay_frame_bits(scene, cfg: RenderConfig, seed, sample_ids, rec):
    """The tangent-frame branch bits [P*(D-1), N] the replay takes at this
    scene: the frozen-topology side data of the fixed-topology
    finite-difference check (pass as `frame_bits`)."""
    bits: list = []
    with torch.no_grad():
        _replay_radiance(scene, cfg, seed, sample_ids, rec,
                         collect_frame_bits=bits)
    if not bits:
        return torch.zeros((0, sample_ids.shape[0]), dtype=torch.bool,
                           device=sample_ids.device)
    return torch.stack(bits)


def _replay_radiance(scene, cfg: RenderConfig, seed, sample_ids, rec,
                     frame_bits=None, collect_frame_bits=None):
    """Differentiable re-computation of the kernel's radiance [N, 3] from
    its hit records `rec` ([K, N]), written with the wavefront's batched
    ops (the JAX package's `_replay_radiance`): per bounce the recorded
    sphere's quadratic or triangle's Moller-Trumbore t, the shared
    hit_geometry and gather_material, shading gated by the recorded
    unshadowed bits; no scans. Shades without fog, as the JAX oracle does.
    `frame_bits` ([P*(D-1), N] bool) freezes the tangent-frame branch."""
    from skele_raytracer_tpu_torch.ops import sampling
    from skele_raytracer_tpu_torch.ops.camera import rays_for_ids
    from skele_raytracer_tpu_torch.ops.geometry import (
        _pos_sqrt,
        dot,
        hit_geometry,
        norm,
        offset_origin,
        replay_triangle_t,
    )
    from skele_raytracer_tpu_torch.ops.shading import gather_material

    q = cfg.quirks
    rec = rec.to(torch.int64) & _MASK
    S = scene.spheres.mask.shape[0]
    point_on = scene.has_point_lights and not (
        scene.has_fog and scene.fog_zeroed)
    dir_on = scene.has_directional
    Lp = scene.point_lights.mask.shape[0]

    def unpack_rec(r):
        idx = r & 0xFF
        hit = ((r >> 8) & 1) > 0
        tri = ((r >> 9) & 1) > 0
        kind = torch.where(tri, 2, torch.where(hit, 1, 0))
        return idx, kind

    def replay_hit(o, d, idx, kind):
        sel = torch.clamp(torch.where(kind == 1, idx, 0), max=S - 1)
        cen = scene.spheres.center[sel]
        rad = scene.spheres.radius[sel]
        ec = o - cen
        a = dot(d, d)
        b = 2.0 * dot(d, ec)
        c = dot(ec, ec) - rad ** 2
        t_sph = (-b - _pos_sqrt(b * b - 4.0 * a * c)) / (2.0 * a)
        if scene.has_triangles:
            tr = scene.triangles
            t_tri = replay_triangle_t(o, d, tr.v0, tr.v1, tr.v2,
                                      torch.where(kind == 2, idx, 0))
            t = torch.where(kind == 2, t_tri,
                            torch.where(kind == 1, t_sph, 0.0))
        else:
            t = torch.where(kind == 1, t_sph, 0.0)
        x, n = hit_geometry(o, d, scene, kind, idx, t)
        return x, n, gather_material(scene, kind, idx, quirks=q)

    def gates_from_bits(r, base_bit, count):
        if not cfg.use_shadows:
            return torch.ones((r.shape[0], count), dtype=torch.float32,
                              device=r.device)
        cols = torch.arange(count, device=r.device)[None, :]
        return ((r[:, None] >> (base_bit + cols)) & 1).to(torch.float32)

    def blinn_phong(n, view, ldir, mat, colour, falloff, gate):
        ndotl = torch.clamp(dot(n[:, None, :], ldir), min=0.0)
        h_raw = view[:, None, :] + ldir
        h = h_raw / torch.clamp(norm(h_raw, keepdims=True), min=1e-30)
        ndoth = torch.clamp(dot(n[:, None, :], h), min=0.0)
        spow = torch.pow(torch.clamp(ndoth, min=1e-30),
                         mat.power[:, None]) * (ndoth > 0)
        dif = mat.diffuse[:, None, :] * colour[None] * (falloff * ndotl)[
            :, :, None]
        spc = mat.specular[:, None, :] * colour[None] * (falloff * spow)[
            :, :, None]
        return torch.sum((dif + spc) * gate[:, :, None], dim=1)

    def shade_replay(x, n, mat, r):
        total = scene.ambient[None, :] * mat.ambient
        if not (point_on or dir_on):
            return total
        view = normalize(scene.camera.position[None, :] - x)
        if point_on:
            pl_ = scene.point_lights
            gate = gates_from_bits(r, 10, Lp) * pl_.mask[None, :]
            l_vec = pl_.position[None, :, :] - x[:, None, :]
            d_l = norm(l_vec)
            ldir = l_vec / torch.clamp(d_l, min=1e-30)[:, :, None]
            falloff = 1.0 / torch.clamp(d_l * d_l, min=1e-30)
            total = total + blinn_phong(n, view, ldir, mat, pl_.colour,
                                        falloff, gate)
        if dir_on:
            dl_ = scene.directional_lights
            Ld = dl_.mask.shape[0]
            gate = gates_from_bits(r, 10 + Lp, Ld) * dl_.mask[None, :]
            ldir = normalize(dl_.direction)[None, :, :].expand(
                x.shape[0], Ld, 3)
            total = total + blinn_phong(n, view, ldir, mat, dl_.colour,
                                        torch.ones_like(gate), gate)
        return total

    def shades_miss(kind):
        sh = (kind == 1) if q.triangles_shade_black else (kind > 0)
        return sh[:, None], (kind == 0)[:, None]

    o, d = rays_for_ids(scene.camera, cfg, seed, sample_ids)
    idx0, kind0 = unpack_rec(rec[0])
    x0, n0, mat0 = replay_hit(o, d, idx0, kind0)
    direct0 = shade_replay(x0, n0, mat0, rec[0])
    bg = scene.background[None, :].expand_as(direct0)
    sh0, miss0 = shades_miss(kind0)
    if not cfg.monte_carlo:
        return torch.where(miss0, bg, torch.where(sh0, direct0, 0.0))
    l0 = torch.where(miss0, bg,
                     torch.where(sh0, direct0 / _PI * mat0.diffuse, 0.0))
    D, P = cfg.max_depth, cfg.paths_per_sample
    if D <= 1:
        return l0
    acc = torch.zeros_like(l0)
    ids64 = sample_ids.to(torch.int64) & _MASK
    for p in range(P):
        pid = (ids64 * P + p) & _MASK
        xb, nb, difb, shb = x0, n0, mat0.diffuse, sh0.to(torch.float32)
        T = None
        for b in range(1, D):
            rdraw = sampling.uniform(seed, pid, b - 1, sampling.PURPOSE_PATH,
                                     (2,))
            r1, r2 = rdraw[:, 0], rdraw[:, 1]
            smp = sampling.uniform_sample_hemi(r1, r2)
            fb = (None if frame_bits is None
                  else frame_bits[p * (D - 1) + (b - 1)])
            if collect_frame_bits is not None:
                collect_frame_bits.append(
                    torch.abs(nb[..., 0]) > torch.abs(nb[..., 1]))
            d_new = sampling.to_world(smp, nb, quirks=q, use_x=fb)
            if not q.unnormalized_ray_dirs:
                d_new = normalize(d_new)
            if q.scalar_epsilon_offset:
                o_new = xb + INDIRECT_ORIGIN_EPS
            else:
                o_new = offset_origin(xb, nb)
            f = 2.0 * _PI * r1[:, None] * difb
            T = f * shb if T is None else T * f * shb
            rk = rec[1 + p * (D - 1) + (b - 1)]
            idxb, kindb = unpack_rec(rk)
            xb, nb, matb = replay_hit(o_new, d_new, idxb, kindb)
            directb = shade_replay(xb, nb, matb, rk)
            shb_c, missb = shades_miss(kindb)
            acc = acc + T * torch.where(
                missb, bg,
                torch.where(shb_c, directb / _PI * matb.diffuse, 0.0))
            difb, shb = matb.diffuse, shb_c.to(torch.float32)
    return l0 + acc / P


def _replay_chunked(scene, cfg: RenderConfig, seed, sample_ids, rec,
                    frame_bits=None):
    """`_replay_radiance` chunk by chunk, each chunk recomputed in the
    backward pass (`torch.utils.checkpoint`), as the JAX package's
    `_replay_chunked` does with `jax.checkpoint`."""
    from torch.utils.checkpoint import checkpoint

    n = sample_ids.shape[0]
    fan = max(cfg.paths_per_sample, 1)
    chunk = max(128, min(max(1, cfg.rays_per_chunk // fan), n))
    out = []
    for i in range(0, n, chunk):
        fb = None if frame_bits is None else frame_bits[:, i:i + chunk]
        out.append(checkpoint(_replay_radiance, scene, cfg, seed,
                              sample_ids[i:i + chunk], rec[:, i:i + chunk],
                              fb, use_reentrant=False))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of `fm::Params` (csrc/frame_math.cuh), field for field."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "n", "S", "T", "L", "LD", "F",
        "sph_on", "tri_on", "point_on", "dir_on", "use_shadows", "mc",
        "P", "D", "grid",
        "unnormalized_dirs", "diagonal_jitter", "ref_test", "buggy_tangent",
        "tri_black", "shadow_tris", "clean_offsets", "shadow_bound")] + [
        ("seed", ctypes.c_uint32)] + [(name, ctypes.c_float) for name in (
            "angle", "aspect", "inv_w", "inv_h", "clip2", "inv_p")]


def _params(n: int, seed, static: dict) -> _Params:
    q = static["quirks"]
    t_clip = 1.0 if q.near_clip_t_le_1 else CLEAN_T_EPS
    f32 = lambda v: float(np.float32(v))
    return _Params(
        n=n, S=static["S"], T=static["T"], L=static["L"], LD=static["LD"],
        F=static["F"], sph_on=static["sph_on"], tri_on=static["tri_on"],
        point_on=static["point_on"], dir_on=static["dir_on"],
        use_shadows=static["use_shadows"], mc=static["mc"], P=static["P"],
        D=static["D"], grid=static["grid"],
        unnormalized_dirs=q.unnormalized_ray_dirs,
        diagonal_jitter=q.diagonal_jitter,
        ref_test=q.reference_triangle_test,
        buggy_tangent=q.buggy_tangent_frame,
        tri_black=q.triangles_shade_black,
        shadow_tris=static["tri_on"] and not q.sphere_only_shadows,
        clean_offsets=not q.scalar_epsilon_offset,
        shadow_bound=not q.near_clip_t_le_1,
        seed=int(seed) & _MASK,
        angle=f32(static["angle"]),
        aspect=f32(static["width"] / float(static["height"])),
        inv_w=f32(1.0 / static["width"]), inv_h=f32(1.0 / static["height"]),
        clip2=f32(2.0 * t_clip), inv_p=f32(1.0 / static["P"]),
    )


# Each table's row width (csrc/frame_math.cuh) and its row count's key in
# the static arguments.
_TABLE_SHAPES = (("sph", 16, "S"), ("tri", 24, "T"), ("misc", 24, None),
                 ("pl", 8, "L"), ("dl", 8, "LD"))

_lib = None


def bind(lib):
    """Declares `pathtrace_forward` of a loaded library and checks its
    Params size."""
    lib.pathtrace_forward.argtypes = (
        [ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 16)
    lib.pathtrace_forward.restype = ctypes.c_int
    lib.pathtrace_params_size.restype = ctypes.c_int
    if lib.pathtrace_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("fm::Params and _Params disagree in size")
    return lib


def build_kernel():
    """Build (if needed) and load the CUDA kernel library."""
    global _lib
    if _lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        _lib = bind(load_cuda("pathtrace"))
    return _lib


def kernel_config() -> str:
    """The kernel's scan order and launch shape ("U4 256x4, lit U1": rows
    per scan step, threads per block x minimum blocks per SM, the rows per
    step of the instance with lights)."""
    lib = build_kernel()
    lib.pathtrace_config.restype = ctypes.c_char_p
    return lib.pathtrace_config().decode()


_bwd_lib = None


def bind_backward(lib):
    """Declares `pathtrace_backward`, `pathtrace_bwd_partial_floats` and
    `pathtrace_bwd_lanes_for` (the lanes per sample the launcher takes) of
    a loaded library."""
    lib.pathtrace_backward.argtypes = (
        [ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 17)
    lib.pathtrace_backward.restype = ctypes.c_int
    lib.pathtrace_bwd_partial_floats.argtypes = [ctypes.POINTER(_Params)]
    lib.pathtrace_bwd_partial_floats.restype = ctypes.c_longlong
    lib.pathtrace_bwd_lanes_for.argtypes = [ctypes.POINTER(_Params)]
    lib.pathtrace_bwd_lanes_for.restype = ctypes.c_int
    return lib


def build_backward_kernel():
    """Build (if needed) and load the backward kernel library."""
    global _bwd_lib
    if _bwd_lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        _bwd_lib = bind_backward(load_cuda("pathtrace_bwd"))
    return _bwd_lib


def check_inputs(tabs, planes, static: dict) -> None:
    """Device, dtype and shape checks of the kernel's operands (also used
    by the tests' host build of its math)."""
    dev = planes[0].device
    n = planes[0].shape[0]
    if n >= 2**31:
        raise ValueError(f"{n} samples: the kernel takes fewer than 2^31")
    for name, t in zip(("ids", "xs", "ys", "cj", "ci"), planes):
        if t.device != dev or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"plane {name}: expected [{n}] on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        want = torch.int64 if name == "ids" else torch.float32
        if t.dtype != want:
            raise ValueError(f"plane {name}: dtype {t.dtype}, want {want}")
    rows = dict(static, misc=1 + static["F"])
    for t, (name, width, key) in zip(tabs, _TABLE_SHAPES):
        want = (rows[key or name], width)
        if tuple(t.shape) != want:
            raise ValueError(f"table {name}: shape {tuple(t.shape)}, "
                             f"want {want}")
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"table {name}: {t.dtype} on {t.device}, want "
                             f"float32 on {dev}")
    if static["S"] > MAX_SPHERES or static["T"] > MAX_TRIS or (
            static["F"] > MAX_FOG):
        raise ValueError("scene exceeds the kernel's table limits")


def _kernel_args(tabs, planes):
    """Contiguous kernel operands: the tables, the ids as int32 (the
    uint32 bit pattern) and the float planes."""
    ids = planes[0]
    ids32 = torch.where(ids >= 2**31, ids - 2**32, ids).to(torch.int32)
    return [t.contiguous() for t in tabs] + [ids32] + [
        p.contiguous() for p in planes[1:]]


@profiling.spanned("launch.k1")
def pathtrace_forward(tabs, planes, seed, static: dict, records=False):
    """Radiance planes (r, g, b) for the sample planes, plus the [K, N]
    int32 hit records when `records`. CPU tensors run the plain version
    `frame_math_torch`; CUDA tensors launch the kernel (counted in
    LAUNCHES["pathtrace"], or ["pathtrace_records"] for the records
    variant) or raise. `seed`: an int, or a 0-d int64 tensor, which the
    kernel reads from the device when it runs (a frame's CUDA graph,
    models/graphs.py, writes each replay's seed there)."""
    check_inputs(tabs, planes, static)
    dev = planes[0].device
    if dev.type == "cpu":
        return frame_math_torch(tabs, planes, seed, emit_records=records,
                                **static)
    if dev.type != "cuda":
        raise ValueError(f"pathtrace: no kernel for device {dev}")
    lib = build_kernel()
    n = planes[0].shape[0]
    args = _kernel_args(tabs, planes)
    out = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3)]
    recs = (torch.empty((_static_n_records(static), n), dtype=torch.int32,
                        device=dev) if records else None)
    seed_dev = None
    if isinstance(seed, torch.Tensor):
        seed_dev, seed = seed.to(device=dev, dtype=torch.int64).reshape(()), 0
    params = _params(n, seed, static)
    ptrs = [t.data_ptr() for t in args + out]
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.pathtrace_forward(
            ctypes.byref(params), *ptrs,
            None if recs is None else recs.data_ptr(),
            None if seed_dev is None else seed_dev.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pathtrace kernel launch failed: CUDA error {err}")
    name = "pathtrace_records" if records else "pathtrace"
    LAUNCHES[name] += 1
    check_outputs(name, *out)
    return tuple(out) + ((recs,) if records else ())


def _static_n_records(static: dict) -> int:
    """`_n_records` from the kernel's static arguments."""
    if not static["mc"] or static["D"] <= 1:
        return 1
    return 1 + static["P"] * (static["D"] - 1)


def record_counts(recs, tabs, static: dict) -> dict:
    """What the hit records `recs` ([K, N], `_pack_record`) say: per slot
    (0 the primary hit, then each (path, bounce)) the records and those
    whose hit bit is set; per light kind ("point", "directional") the
    shadow tests of the hit records, one per live light (mask > 0 in its
    table), and those that came back unshadowed. K1 also scans for the
    records that miss; those tests are not counted. Without shadows, or
    with a kind's block off, its tests are 0."""
    recs = recs.to(torch.int64)
    hit = (recs >> 8) & 1
    per_slot = hit.sum(1).tolist()
    out = {"slots": [{"records": recs.shape[1], "hits": h}
                     for h in per_slot]}
    kinds = (("point", 10, static["point_on"], tabs[3]),
             ("directional", 10 + static["L"], static["dir_on"], tabs[4]))
    for kind, base, on, tab in kinds:
        tests = unshadowed = 0
        if static["use_shadows"] and on:
            for li, alive in enumerate((tab[:, 6] > 0).tolist()):
                if alive:
                    tests += sum(per_slot)
                    unshadowed += int((hit & (recs >> (base + li))).sum())
        out[kind] = {"tests": tests, "unshadowed": unshadowed}
    return out


def replay_table_grads(tabs, planes, recs, g, seed, static: dict):
    """The plain version of the backward kernel: `torch.autograd.grad` of
    sum(replay radiance * g) with respect to the five tables, replayed
    from the records `recs` ([K, N]); g is the [N, 3] radiance
    cotangent."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in tabs]
        r, gg, b = frame_math_torch(leaves, planes, seed, recs_in=recs,
                                    **static)
        loss = (r * g[:, 0] + gg * g[:, 1] + b * g[:, 2]).sum()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip(tabs, grads))


def grad_layout(static: dict):
    """(row count, row width) of each table's gradient in the backward
    kernel's flat output (csrc/frame_adjoint.cuh GradLayout)."""
    rows = dict(static, misc=1 + static["F"])
    return [(rows[key or name], width) for name, width, key in _TABLE_SHAPES]


def split_grads(flat, static: dict):
    """The backward kernel's flat gradient as the five tables."""
    out, off = [], 0
    for rows, width in grad_layout(static):
        out.append(flat[off:off + rows * width].view(rows, width))
        off += rows * width
    return tuple(out)


@profiling.spanned("launch.k2")
def pathtrace_backward(tabs, planes, recs, g, seed, static: dict):
    """The five table cotangents of sum(radiance * g) for the samples
    whose records the forward returned. CPU tensors run the plain version
    (`replay_table_grads`); CUDA tensors launch the backward kernel
    (csrc/pathtrace_bwd.cu: stage 1 and its reduce, counted once in
    LAUNCHES["pathtrace_bwd"]) or raise."""
    check_inputs(tabs, planes, static)
    dev = planes[0].device
    n = planes[0].shape[0]
    K = _static_n_records(static)
    if tuple(recs.shape) != (K, n) or tuple(g.shape) != (n, 3):
        raise ValueError(f"records {tuple(recs.shape)} / cotangent "
                         f"{tuple(g.shape)}: want ({K}, {n}) / ({n}, 3)")
    if dev.type == "cpu":
        return replay_table_grads(tabs, planes, recs, g, seed, static)
    if dev.type != "cuda":
        raise ValueError(f"pathtrace backward: no kernel for device {dev}")
    if recs.device != dev or g.device != dev:
        raise ValueError("records and cotangent must be on the planes' device")
    lib = build_backward_kernel()
    args = _kernel_args(tabs, planes)
    params = _params(n, seed, static)
    total = sum(r * w for r, w in grad_layout(static))
    with torch.cuda.device(dev):
        floats = lib.pathtrace_bwd_partial_floats(ctypes.byref(params))
    if floats < 0:
        raise ValueError("pathtrace backward kernel: no launch shape for "
                         "this scene's tables (shared memory)")
    partial = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    gc = g.to(torch.float32)
    cot = [gc[:, c].contiguous() for c in range(3)]
    recs32 = recs.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = ([t.data_ptr() for t in args] + [recs32.data_ptr()]
                + [t.data_ptr() for t in cot]
                + [partial.data_ptr(), flat.data_ptr()])
        err = lib.pathtrace_backward(ctypes.byref(params), *ptrs,
                                     ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"pathtrace backward kernel launch failed: CUDA error {err}")
    LAUNCHES["pathtrace_bwd"] += 1
    check_outputs("pathtrace_bwd", flat)
    return split_grads(flat, static)


class _PathTrace(torch.autograd.Function):
    """Radiance [N, 3] of the five tables: the forward kernel (with
    records when a table needs a gradient), the backward kernel for the
    table cotangents. `_pack_tables` is plain differentiable torch, so
    autograd maps the table cotangents back onto scene leaves (the JAX
    package's `jax.vjp(_pack_tables)`)."""

    @staticmethod
    def forward(ctx, seed, static, planes, *tabs):
        want = any(ctx.needs_input_grad[3:])
        out = pathtrace_forward(tabs, planes, seed, static, records=want)
        if want:
            ctx.save_for_backward(*tabs, *planes, out[3])
            ctx.seed, ctx.static = seed, static
            profiling.COUNTERS["k1.records"].hold(
                lambda recs=out[3]: record_counts(recs, tabs, static))
        return torch.stack(out[:3], dim=1)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        tabs, planes, recs = saved[:5], saved[5:10], saved[10]
        grads = pathtrace_backward(tabs, planes, recs, g.contiguous(),
                                   ctx.seed, ctx.static)
        return (None, None, None) + tuple(
            d if need else None
            for d, need in zip(grads, ctx.needs_input_grad[3:]))


class _WavefrontGrad(torch.autograd.Function):
    """The forward kernel's radiance, with the gradient re-derived through
    the wavefront under autograd (the JAX package's `_pt_bwd` when the
    records do not fit, `_can_replay`): the estimator is the same."""

    @staticmethod
    def forward(ctx, scene, cfg, seed, sample_ids, *leaves):
        ctx.scene, ctx.cfg, ctx.seed = scene, cfg, seed
        ctx.save_for_backward(sample_ids, *leaves)
        tabs = _pack_tables(scene)
        planes = _plane_inputs(cfg, sample_ids)
        out = pathtrace_forward(tabs, planes, seed,
                                _static_kernel_args(scene, cfg))
        return torch.stack(out, dim=1)

    @staticmethod
    def backward(ctx, g):
        from skele_raytracer_tpu_torch.models.renderer import (
            render_ids_wavefront,
        )
        from skele_raytracer_tpu_torch.scene.types import (
            replace_leaves,
            with_live_normals,
        )

        sample_ids, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            fresh = [t.detach().requires_grad_(bool(n))
                     for t, n in zip(leaves, need)]
            scene = with_live_normals(replace_leaves(ctx.scene, fresh))
            radiance = render_ids_wavefront(scene, ctx.cfg, ctx.seed,
                                            sample_ids)
            wrt = [t for t, n in zip(fresh, need) if n]
            grads = iter(torch.autograd.grad(radiance, wrt, g,
                                             allow_unused=True))
        out = [next(grads) if n else None for n in need]
        out = [torch.zeros_like(t) if n and d is None else d
               for t, n, d in zip(leaves, need, out)]
        return (None, None, None, None) + tuple(out)


def pathtrace_ids(scene, cfg: RenderConfig, seed, sample_ids):
    """Whole-frame radiance [N, 3] for flat sample ids, on sample_ids'
    device (the scene must be there too), differentiable in the scene's
    leaves: with records and the backward kernel where they fit
    (`_can_replay`), else through the wavefront (`_WavefrontGrad`)."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in scene.tensors())
    if needs_grad and not _can_replay(scene, cfg):
        from skele_raytracer_tpu_torch.scene.types import scene_leaves

        return _WavefrontGrad.apply(scene, cfg, seed, sample_ids,
                                    *scene_leaves(scene))
    tabs = _pack_tables(scene)
    planes = _plane_inputs(cfg, sample_ids)
    return _PathTrace.apply(seed, _static_kernel_args(scene, cfg), planes,
                            *tabs)


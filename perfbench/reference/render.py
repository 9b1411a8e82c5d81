"""The plain reference renderer: radiance of flat sample ids, in plain
PyTorch, for the linear integrator (parity, and clean Monte-Carlo).

Written from the upstream tracer's semantics (lilinitsy/skele-raytracer
src/main.cpp, src/raytrace.h, src/blinn_phong.h, src/utils.h) with the
program's published conventions for what the upstream leaves undefined:
counter-based threefry2x32 draws keyed by (seed, bounce, purpose) with
the sample id as counter, one uniform per draw from the top 24 bits;
Monte-Carlo depth as linear continuation paths (num_paths per sample,
throughput 2 pi r1 diffuse). It imports nothing of the program: it reads
the scene from `scene.py`'s own parse and works out camera rays, draws,
sphere and Moller-Trumbore tests, Blinn-Phong, fog and bounces itself,
brute force (every ray against every primitive, in blocks).

`dtype` sets the precision of all floating-point work, so the same code
is the reference (float32) and its control (bfloat16). Every function is
differentiable in the scene's float leaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

CLEAN_T_EPS = 1e-4  # clean near clip of secondary and shadow hits
SHADOW_ORIGIN_EPS = 1e-6  # parity's shadow-origin add (src/utils.h:46)
INDIRECT_ORIGIN_EPS = 1e-5  # parity's bounce-origin add (src/raytrace.h:128)
TRIANGLE_DET_EPS = 1e-5  # src/utils.h:190
MASK32 = 0xFFFFFFFF
JITTER, PATH, FOG = 0, 1, 2  # draw purposes
GOLDEN = 0x9E3779B9
TWO_PI32 = float(np.float32(2.0 * np.pi))
PAIR_BLOCK = 1 << 23  # (ray, triangle) pairs per block of a triangle scan


@dataclass(frozen=True)
class Config:
    """What a render needs besides the scene: the frame, the semantics and
    the integrator's settings, as a cell's configuration file states
    them (gillum 0: no Monte-Carlo paths)."""

    width: int
    height: int
    parity: bool
    gillum: int = 0
    depth: int = 1
    shadows: bool = False
    jsample: int = 0
    fov: float = 60.0

    @property
    def spp(self) -> int:
        return self.jsample * self.jsample if self.jsample > 0 else 1

    @property
    def paths(self) -> int:
        return self.gillum if self.gillum > 0 else 1


# --------------------------------------------------------------------------
# threefry2x32 (20 rounds), on int64 tensors holding uint32 values
# --------------------------------------------------------------------------


def threefry2x32(k0: int, k1: int, x0, x1):
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ 0x1BD11BDA) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for g in range(5):
        for r in rot[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK32) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK32
    return x0, x1


def uniform(seed, ids, bounce, purpose, n, dtype):
    """[len(ids), n] draws in [0, 1): draw i from word i % 2 of the
    counter (id, i // 2) under key (seed, bounce * golden + purpose)."""
    m = (n + 1) // 2
    x0 = (ids.to(torch.int64) & MASK32)[:, None].expand(-1, m)
    x1 = torch.arange(m, device=ids.device)[None, :].expand(ids.shape[0], m)
    y0, y1 = threefry2x32(int(seed), bounce * GOLDEN + purpose, x0, x1)
    u = torch.stack([y0, y1], -1).reshape(ids.shape[0], 2 * m)[:, :n]
    return ((u >> 8).to(torch.float32) * 2.0 ** -24).to(dtype)


# --------------------------------------------------------------------------
# vector helpers, over a last axis of 3
# --------------------------------------------------------------------------


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def pos_sqrt(x):
    pos = x > 0
    return torch.sqrt(torch.where(pos, x, 1.0)) * pos


def norm(v):
    return pos_sqrt(dot(v, v))


def normalize(v):
    n = norm(v)[..., None]
    return v * torch.where(n > 0, 1.0 / torch.where(n > 0, n, 1.0), 0.0)


def offset_along(p, n):
    """Clean secondary origins: off the surface along its normal, by a
    step that grows with the point's distance from the origin."""
    return p + (CLEAN_T_EPS * (1.0 + norm(p)[..., None])) * n


# --------------------------------------------------------------------------
# camera
# --------------------------------------------------------------------------


def camera_rays(scene, cfg: Config, seed, ids, dtype):
    """Primary rays of flat sample ids (pixel * spp + sample)."""
    W, H, spp = cfg.width, cfg.height, cfg.spp
    pixel = (ids // spp).to(torch.float32)
    sample = (ids % spp).to(torch.float32)
    xs = torch.fmod(pixel, W).to(dtype)
    ys = torch.floor(pixel / W).to(dtype)
    if cfg.jsample > 0 and cfg.parity:  # one draw for both axes
        jx = jy = uniform(seed, ids, 0, JITTER, 1, dtype)[:, 0]
    elif cfg.jsample > 0:  # stratified cells
        n = cfg.jsample
        r = uniform(seed, ids, 0, JITTER, 2, dtype)
        jx = (torch.fmod(sample, n).to(dtype) + r[:, 0]) / n
        jy = (torch.floor(sample / n).to(dtype) + r[:, 1]) / n
    else:
        jx = jy = 0.5
    angle = float(np.float32(np.tan(np.pi * 0.5 * cfg.fov / 180.0)))
    u = (2.0 * ((xs + jx) * (1.0 / W)) - 1.0) * angle * (W / float(H))
    v = (1.0 - 2.0 * ((ys + jy) * (1.0 / H))) * angle
    cam = scene.camera
    right = cross(-cam["direction"], cam["up"])
    d = (cam["direction"][None, :] + u[:, None] * right[None, :]
         + v[:, None] * cam["up"][None, :])
    if not cfg.parity:
        d = normalize(d)
    return cam["position"][None, :].expand(d.shape), d


# --------------------------------------------------------------------------
# intersection
# --------------------------------------------------------------------------


def sphere_t(o, d, sph, t_clip):
    """[R, S] smaller root of each (ray, sphere) quadratic; inf where it
    misses or lies at or before t_clip."""
    ec = o[:, None, :] - sph["center"][None, :, :]
    a = dot(d, d)[:, None]
    b = 2.0 * dot(d[:, None, :], ec)
    c = dot(ec, ec) - sph["radius"][None, :] ** 2
    disc = b * b - 4.0 * a * c
    t = (-b - pos_sqrt(disc)) / (2.0 * torch.where(a > 0, a, 1.0))
    ok = (disc >= 0) & (t >= 0) & (t > t_clip)
    return torch.where(ok, t, math.inf)


def triangle_t(o, d, tri, lo, hi, parity):
    """[R, hi - lo] Moller-Trumbore t of each ray against triangles
    lo..hi; inf where it misses. Parity keeps the upstream's variant
    (src/utils.h:181-213): u from -(o - v0), no t > 0 test."""
    v0, v1, v2 = tri["v0"][lo:hi], tri["v1"][lo:hi], tri["v2"][lo:hi]
    e1, e2 = v1 - v0, v2 - v0
    p = cross(d[:, None, :], e2[None])
    det = dot(e1[None], p)
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tv = o[:, None, :] - v0[None]
    u = dot(-tv if parity else tv, p) * inv
    q = cross(tv, e1[None])
    v = dot(d[:, None, :], q) * inv
    t = dot(e2[None], q) * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    if not parity:
        ok = ok & (t > CLEAN_T_EPS)
    return torch.where(ok, t, math.inf)


def _tri_block(n_rays, n_tris):
    return max(1, min(n_tris, PAIR_BLOCK // max(n_rays, 1)))


def nearest_triangle(o, d, tri, parity):
    """(t, index) of each ray's nearest triangle (the first on a tie),
    scanning triangle blocks; t is inf on a miss. The search runs without
    autograd; t is then taken again at the index, differentiably, by the
    same arithmetic."""
    T = tri["v0"].shape[0]
    step = _tri_block(o.shape[0], T)
    with torch.no_grad():
        best = torch.full((o.shape[0],), math.inf, dtype=o.dtype,
                          device=o.device)
        idx = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
        for lo in range(0, T, step):
            t = triangle_t(o.detach(), d.detach(), tri, lo, lo + step, parity)
            bt, bi = torch.min(t, dim=1)
            win = bt < best
            best = torch.where(win, bt, best)
            idx = torch.where(win, bi + lo, idx)
    t = _paired_t(o, d, {k: tri[k][idx] for k in ("v0", "v1", "v2")})
    return torch.where(torch.isfinite(best), t, math.inf), idx


def _paired_t(o, d, sel):
    """t of each ray against its own triangle (sel: [R, 3] vertices)."""
    v0, v1, v2 = sel["v0"], sel["v1"], sel["v2"]
    e1, e2 = v1 - v0, v2 - v0
    p = cross(d, e2)
    det = dot(e1, p)
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    q = cross(o - v0, e1)
    return dot(e2, q) * inv


def any_triangle(o, d, tri, parity, bound=None):
    """[R] bool: does any triangle hit the ray (before `bound`, where
    given)?"""
    T = tri["v0"].shape[0]
    step = _tri_block(o.shape[0], T)
    hit = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    with torch.no_grad():
        for lo in range(0, T, step):
            t = triangle_t(o.detach(), d.detach(), tri, lo, lo + step, parity)
            ok = torch.isfinite(t)
            if bound is not None:
                ok = ok & (t < bound.detach()[:, None])
            hit = hit | ok.any(1)
    return hit


def intersect(scene, cfg, o, d):
    """Nearest hit: (kind 0 miss / 1 sphere / 2 triangle, index, t,
    point, normal). A triangle wins only with a strictly smaller t."""
    R = o.shape[0]
    t_clip = 1.0 if cfg.parity else CLEAN_T_EPS
    sph, tri = scene.spheres, scene.triangles
    inf = torch.full((R,), math.inf, dtype=o.dtype, device=o.device)
    if sph:
        ts = sphere_t(o, d, sph, t_clip)
        s_idx = torch.argmin(ts, dim=1)
        s_t = torch.gather(ts, 1, s_idx[:, None])[:, 0]
    else:
        s_idx = torch.zeros((R,), dtype=torch.int64, device=o.device)
        s_t = inf
    s_hit = torch.isfinite(s_t)
    if tri:
        g_t, g_idx = nearest_triangle(o, d, tri, cfg.parity)
        g_win = torch.isfinite(g_t) & (g_t < s_t)
    else:
        g_win = torch.zeros((R,), dtype=torch.bool, device=o.device)
        g_idx, g_t = s_idx, inf
    kind = torch.where(g_win, 2, torch.where(s_hit, 1, 0))
    index = torch.where(g_win, g_idx, s_idx)
    t = torch.where(g_win, g_t, s_t)
    point = o + d * torch.where(torch.isfinite(t), t, 0.0)[:, None]
    if sph:
        normal = normalize(point - sph["center"][s_idx])
    else:
        normal = torch.zeros_like(point)
    if tri:
        i = g_idx
        n_tri = normalize(cross(tri["v1"][i] - tri["v0"][i],
                                tri["v2"][i] - tri["v0"][i]))
        n_tri = n_tri * torch.where(dot(n_tri, d) > 0, -1.0, 1.0)[:, None]
        normal = torch.where((kind == 2)[:, None], n_tri, normal)
    return kind, index, t, point, normal


def material(scene, cfg, kind, index):
    """{key: [R, ...]} material at each hit: the sphere's, or in clean
    mode the triangle's where a triangle won (parity never shades a
    triangle)."""
    out = {}
    for k in ("ambient", "diffuse", "specular", "power"):
        parts = []
        for grp, on in ((scene.spheres, kind != 2),
                        (scene.triangles, kind == 2)):
            if not grp or (cfg.parity and grp is scene.triangles):
                continue
            n = grp[k].shape[0]
            rows = grp[k][torch.clamp(index, max=n - 1)]
            keep = on & (index < n) if cfg.parity else on
            shape = (-1,) + (1,) * (rows.dim() - 1)
            parts.append(rows * keep.to(rows.dtype).reshape(shape))
        out[k] = sum(parts) if parts else torch.zeros(
            (kind.shape[0],) + ((3,) if k != "power" else ()),
            dtype=scene.ambient.dtype, device=kind.device)
    return out


# --------------------------------------------------------------------------
# shading
# --------------------------------------------------------------------------


def unshadowed(scene, cfg, x, n, ldir, bound):
    """[R] bool: is the light in direction `ldir` visible from x? Parity
    adds 1e-6 to each component of the origin and lets spheres alone
    occlude, with no bound; clean offsets along the normal, clips at
    1e-4, bounds a point light's occluders by its distance and lets
    triangles occlude."""
    origin = x + SHADOW_ORIGIN_EPS if cfg.parity else offset_along(x, n)
    t_clip = 1.0 if cfg.parity else CLEAN_T_EPS
    if cfg.parity:
        bound = None
    occ = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    with torch.no_grad():
        if scene.spheres:
            ts = sphere_t(origin.detach(), ldir.detach(), scene.spheres,
                          t_clip)
            occ = (ts < bound.detach()[:, None] if bound is not None
                   else torch.isfinite(ts)).any(1)
    if scene.triangles and not cfg.parity:
        occ = occ | any_triangle(origin, ldir, scene.triangles, False, bound)
    return ~occ


def specular_pow(scene, x, n, ldir, power):
    view = normalize(scene.camera["position"][None, :] - x)
    h = view + ldir
    h = h / torch.clamp(norm(h)[:, None], min=1e-30)
    ndoth = torch.clamp(dot(n, h), min=0.0)
    return torch.pow(torch.clamp(ndoth, min=1e-30), power) * (ndoth > 0)


def fog_term(scene, mat, center, ldir, x, n, lpos, lcol, u):
    """One point light's spherical-fog term (src/blinn_phong.h:19-44),
    summed over fog volumes. u [R, F, 4]: interaction and phase draws."""
    fog = scene.fog
    d_cl = torch.minimum(norm(center - lpos[None, :])[:, None],
                         2.0 * fog["radius"][None, :])
    p_none = torch.exp(-d_cl * (fog["absorption"] + fog["scattering"])[None])
    hit = u[..., 0] > p_none  # [R, F]
    d_lx = norm(lpos[None, :] - x)
    inten = 1.0 / torch.clamp(d_lx * d_lx, min=1e-30)
    ndotl = torch.clamp(dot(n, ldir), min=0.0)
    diffuse_like = mat["diffuse"] * lcol[None, :] * (inten * ndotl)[:, None]
    new_l = (ldir[:, None, :]
             + fog["scattering"][None, :, None] * (u[..., 1:4] * 2.0 - 1.0))
    ndotl2 = torch.clamp(dot(n[:, None, :], new_l), min=0.0)
    albedo_like = fog["albedo"][None] * lcol[None, None, :] * ndotl2[..., None]
    return torch.where(hit[..., None], diffuse_like[:, None, :],
                       albedo_like).sum(1)


def direct(scene, cfg, seed, ids, bounce, kind, index, x, n, mat):
    """Ambient + Blinn-Phong of every light at the hit points. With live
    fog, both point-light terms are the fog term, each with its own
    draws; parity's all-zero fog turns the point-light block off."""
    total = scene.ambient[None, :] * mat["ambient"]
    pl = scene.point_lights
    if pl and not scene.fog_zeroed:
        L = pl["position"].shape[0]
        if scene.fog:
            F = scene.fog["center"].shape[0]
            u = uniform(seed, ids, bounce, FOG, L * F * 8, x.dtype)
            u = u.reshape(-1, L, F, 4, 2)
            center = torch.zeros_like(x)
            if scene.spheres:
                S = scene.spheres["center"].shape[0]
                center = (scene.spheres["center"][torch.clamp(index, max=S - 1)]
                          * (index < S).to(x.dtype)[:, None])
            if not cfg.parity:
                center = torch.where((kind == 2)[:, None], x, center)
        for li in range(L):
            pos, col = pl["position"][li], pl["colour"][li]
            lvec = pos[None, :] - x
            dist = norm(lvec)
            ldir = lvec / torch.clamp(dist, min=1e-30)[:, None]
            gate = (unshadowed(scene, cfg, x, n, normalize(lvec), dist)
                    if cfg.shadows else torch.ones_like(dist, dtype=torch.bool))
            if scene.fog:
                dif = fog_term(scene, mat, center, ldir, x, n, pos, col,
                               u[:, li, :, :, 0])
                spec = fog_term(scene, mat, center, ldir, x, n, pos, col,
                                u[:, li, :, :, 1])
            else:
                inten = 1.0 / torch.clamp(dist * dist, min=1e-30)
                ndotl = torch.clamp(dot(n, ldir), min=0.0)
                dif = mat["diffuse"] * col[None, :] * (inten * ndotl)[:, None]
                sp = specular_pow(scene, x, n, ldir, mat["power"])
                spec = mat["specular"] * col[None, :] * (inten * sp)[:, None]
            total = total + (dif + spec) * gate.to(x.dtype)[:, None]
    dl = scene.directional_lights
    for li in range(dl["direction"].shape[0] if dl else 0):
        ldir = normalize(dl["direction"][li])[None, :].expand_as(x)
        gate = (unshadowed(scene, cfg, x, n, ldir, None) if cfg.shadows
                else torch.ones(x.shape[0], dtype=torch.bool,
                                device=x.device))
        ndotl = torch.clamp(dot(n, ldir), min=0.0)
        col = dl["colour"][li][None, :]
        dif = mat["diffuse"] * col * ndotl[:, None]
        spec = mat["specular"] * col * specular_pow(scene, x, n, ldir,
                                                     mat["power"])[:, None]
        total = total + (dif + spec) * gate.to(x.dtype)[:, None]
    return total


def shade_wave(scene, cfg, seed, ids, bounce, o, d):
    """One wave of rays: (point, normal, material, radiance where the ray
    ends here (background on a miss, direct / pi * diffuse on a shaded
    hit, black on parity's triangles), shades)."""
    kind, index, _, x, n = intersect(scene, cfg, o, d)
    mat = material(scene, cfg, kind, index)
    lit = direct(scene, cfg, seed, ids, bounce, kind, index, x, n, mat)
    shades = (kind == 1) | ((kind == 2) & (not cfg.parity))
    if cfg.gillum > 0:
        lit = lit / math.pi * mat["diffuse"]
    ends = torch.where((kind == 0)[:, None], scene.background[None, :],
                       torch.where(shades[:, None], lit, 0.0))
    return x, n, mat, ends, shades


def continue_path(cfg, seed, ids, bounce, x, n, mat):
    """The Monte-Carlo continuation ray (src/raytrace.h:117-131): an
    unweighted hemisphere sample about the normal, through parity's
    skewed frame or a proper one; (origin, direction, 2 pi r1 diffuse)."""
    r = uniform(seed, ids, bounce, PATH, 2, x.dtype)
    r1, r2 = r[:, 0], r[:, 1]
    pos = 1.0 - r1 * r1 > 0
    s = torch.sqrt(torch.where(pos, 1.0 - r1 * r1, 1.0)) * pos
    phi = TWO_PI32 * r2
    sx, sy, sz = s * torch.cos(phi), r1, s * torch.sin(phi)
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    use_x = torch.abs(nx) > torch.abs(ny)
    ia = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=1e-30))
    ib = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=1e-30))
    zero = torch.zeros_like(nx)
    pn = torch.stack([torch.where(use_x, nz * ia, zero),
                      torch.where(use_x, zero, -nz * ib),
                      torch.where(use_x, -nx * ia, ny * ib)], -1)
    pb = cross(n, pn)
    third = (torch.stack([pn[:, 0], pb[:, 1], pb[:, 2]], -1) if cfg.parity
             else pn)
    d = sx[:, None] * pb + sy[:, None] * n + sz[:, None] * third
    if cfg.parity:
        o = x + INDIRECT_ORIGIN_EPS
    else:
        d, o = normalize(d), offset_along(x, n)
    return o, d, 2.0 * math.pi * r1[:, None] * mat["diffuse"]


def radiance(scene, cfg: Config, seed, ids, dtype=torch.float32):
    """[N, 3] radiance of flat sample ids: the primary wave, then each
    sample's paths bounce by bounce, averaged over paths."""
    o, d = camera_rays(scene, cfg, seed, ids, dtype)
    x, n, mat, out, shades = shade_wave(scene, cfg, seed, ids, 0, o, d)
    if cfg.gillum <= 0 or cfg.depth <= 1:
        return out
    P = cfg.paths
    pid = ((ids[:, None] * P + torch.arange(P, device=ids.device)[None, :])
           & MASK32).reshape(-1)
    rep = lambda v: torch.repeat_interleave(v, P, dim=0)
    o, d, f = continue_path(cfg, seed, pid, 0, rep(x), rep(n),
                            {k: rep(v) for k, v in mat.items()})
    through = f * rep(shades)[:, None]
    acc = torch.zeros_like(through)
    for bounce in range(1, cfg.depth):
        x, n, mat, ends, shades = shade_wave(scene, cfg, seed, pid, bounce,
                                             o, d)
        acc = acc + through * ends
        if bounce < cfg.depth - 1:
            o, d, f = continue_path(cfg, seed, pid, bounce, x, n, mat)
            through = through * f * shades[:, None]
    return out + acc.reshape(-1, P, 3).mean(1)


def render_ids(scene, cfg: Config, seed, ids, dtype=torch.float32,
               block=1 << 14):
    """`radiance` of sample ids [N] in blocks of `block` samples."""
    return torch.cat([radiance(scene, cfg, seed, ids[i:i + block], dtype)
                      for i in range(0, ids.shape[0], block)])


def render_pixels(scene, cfg: Config, seed, pixels, dtype=torch.float32):
    """[len(pixels), 3]: each pixel's samples averaged, as a frame holds
    it."""
    spp = cfg.spp
    ids = (pixels.to(torch.int64)[:, None] * spp
           + torch.arange(spp, device=pixels.device)[None, :]).reshape(-1)
    return render_ids(scene, cfg, seed, ids, dtype).reshape(-1, spp, 3).mean(1)

"""Intersection geometry, batched over rays x primitives (the JAX package's
ops/geometry.py).

The reference's per-ray scalar loops (sphere scan src/raytrace.h:152-166,
triangle scan src/raytrace.h:170-187) become [rays, primitives] tensor
computations. Spheres are always scanned in plain torch (scenes carry
tens of them). Triangles go, as in the JAX package's kernel path
(geometry.py:309-371 there), to

* the cluster-culled kernel K3 (ops/cuda/culled.py) when the mesh has more
  than 4 clusters: the coarse clustering for primary waves, the fine one
  for bounce waves (the callers that pass `live`);
* the brute-force kernel K5 (ops/cuda/intersect.py) from 64 triangles;
* the plain [R, T] scan below that.

Each kernel wrapper runs its plain PyTorch version on CPU tensors.

Conventions: rays are (origin [R, 3], direction [R, 3]); directions may be
unnormalized (the reference never normalizes: SURVEY.md §2.9.3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from skele_raytracer_tpu_torch.config import (
    CLEAN_T_EPS,
    SHADOW_ORIGIN_EPS,
    TRIANGLE_DET_EPS,
    Quirks,
)

INF = float("inf")


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (of size 3), x + y + z in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, in jnp.cross's operation order."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _pos_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) as sqrt(where(x > 0, x, 1)) * (x > 0) (finite
    gradient at 0)."""
    pos = x > 0
    return torch.sqrt(torch.where(pos, x, 1.0)) * pos


def norm(v: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """|v| over the last axis."""
    n = _pos_sqrt(dot(v, v))
    return n[..., None] if keepdims else n


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize over the last axis (of size 3); zero vectors map to
    zero."""
    n = norm(v, keepdims=True)
    return v * torch.where(n > 0, 1.0 / torch.where(n > 0, n, 1.0), 0.0)


def offset_origin(point, normal, sign: float = 1.0):
    """Secondary-ray origin offset along the normal, scaled with the
    point's distance from the world origin (clean mode; parity keeps the
    reference's scalar epsilon adds)."""
    scale = CLEAN_T_EPS * (1.0 + norm(point, keepdims=True))
    return point + sign * scale * normal


class SphereHits(NamedTuple):
    t: torch.Tensor  # [R] nearest valid sphere t (inf = none)
    index: torch.Tensor  # [R] int64
    hit: torch.Tensor  # [R] bool


def ray_sphere_all(o, d, center, radius, mask, *, t_clip: float):
    """t of each ray against each sphere, [R, S] (inf where invalid): the
    reference quadratic with its smallest root (src/utils.h:87-121);
    hits with t <= t_clip are rejected.

    A zero direction (the Whitted frontier's total-internal-reflection
    sentinel, ops/shading.py `refraction`) has a = 0 and t2 = -0, which
    t_clip rejects. Its quotient divides by 1 instead of 0: the same
    values, and a finite gradient where the JAX package's 0/0 makes
    every geometry gradient of a Whitted frame NaN."""
    ec = o[:, None, :] - center[None, :, :]  # [R, S, 3]
    a = dot(d, d)[:, None]  # [R, 1]
    b = 2.0 * dot(d[:, None, :], ec)  # [R, S]
    c = dot(ec, ec) - radius[None, :] ** 2
    disc = b * b - 4.0 * a * c
    sq = _pos_sqrt(disc)
    t2 = (-b - sq) / (2.0 * torch.where(a > 0, a, 1.0))
    valid = (disc >= 0) & (t2 >= 0) & (t2 > t_clip) & (mask[None, :] > 0)
    return torch.where(valid, t2, INF)


def nearest_sphere(o, d, center, radius, mask, *, quirks: Quirks) -> SphereHits:
    """Nearest sphere per ray (min over t, the first index on ties)."""
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    t_all = ray_sphere_all(o, d, center, radius, mask, t_clip=t_clip)
    idx = torch.argmin(t_all, dim=1)
    t = torch.gather(t_all, 1, idx[:, None])[:, 0]
    return SphereHits(t=t, index=idx, hit=torch.isfinite(t))


class TriangleHits(NamedTuple):
    t: torch.Tensor  # [R]
    index: torch.Tensor  # [R] int64
    hit: torch.Tensor  # [R] bool
    u: Optional[torch.Tensor]  # [R] (None from K3)
    v: Optional[torch.Tensor]  # [R]


def ray_triangle_all(o, d, v0, v1, v2, mask, *, quirks: Quirks):
    """(t, valid, u, v) of each ray against each triangle, [R, T].

    Parity replicates the reference's Moller-Trumbore variant
    (src/utils.h:181-213): u = dot(-(o - v0), p) / det (a mirrored
    barycentric region) and no t > 0 check. Clean is standard MT with
    t > CLEAN_T_EPS."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(d[:, None, :], e2[None, :, :])  # [R, T, 3]
    det = dot(e1[None, :, :], p)
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    if quirks.reference_triangle_test:
        u = dot(-tvec, p) * inv
    else:
        u = dot(tvec, p) * inv
    q = cross(tvec, e1[None, :, :])
    v = dot(d[:, None, :], q) * inv
    t = dot(e2[None, :, :], q) * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (mask[None, :] > 0)
    if not quirks.reference_triangle_test:
        ok = ok & (t > CLEAN_T_EPS)
    return torch.where(ok, t, INF), ok, u, v


def nearest_triangle(o, d, v0, v1, v2, mask, *, quirks: Quirks) -> TriangleHits:
    """Nearest triangle per ray; in parity "nearest" is the smallest
    signed t (negative-t hits are accepted and win)."""
    t_all, ok, u_all, v_all = ray_triangle_all(o, d, v0, v1, v2, mask,
                                               quirks=quirks)
    idx = torch.argmin(t_all, dim=1)
    t = torch.gather(t_all, 1, idx[:, None])[:, 0]
    pick = lambda a: torch.gather(a, 1, idx[:, None])[:, 0]
    hit = pick(ok) & torch.isfinite(t)
    return TriangleHits(t=t, index=idx, hit=hit, u=pick(u_all), v=pick(v_all))


def replay_triangle_t(o, d, v0, v1, v2, index):
    """Differentiable t of each ray against its SELECTED triangle, [R]
    work (the JAX package's geometry.replay_triangle_t): the same
    Moller-Trumbore t as ray_triangle_all, restricted to triangle[index].
    The kernels decide which triangle wins, forward only; this re-derives
    the winning t so gradients reach rays and vertices."""
    idx = torch.clamp(index.to(torch.int64), max=v0.shape[0] - 1)
    a0, a1, a2 = v0[idx], v1[idx], v2[idx]
    e1 = a1 - a0
    e2 = a2 - a0
    p = cross(d, e2)
    det = dot(e1, p)
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    q = cross(o - a0, e1)
    return dot(e2, q) * inv


class _ReplayTOrKernel(torch.autograd.Function):
    """t of each ray's selected triangle: the kernel's value forward, the
    gradient of `replay_triangle_t` at the recorded index backward (the
    JAX package's `_replay_t_or_kernel`)."""

    @staticmethod
    def forward(ctx, o, d, v0, v1, v2, index, t_kernel):
        ctx.save_for_backward(o, d, v0, v1, v2, index)
        return t_kernel.detach().clone()

    @staticmethod
    def backward(ctx, gt):
        o, d, v0, v1, v2, index = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(bool(n))
                  for t, n in zip((o, d, v0, v1, v2), need)]
            t = replay_triangle_t(*xs, index)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(t, wrt, gt, allow_unused=True))
        out = [next(grads) if n else None for n in need]
        return tuple(out) + (None, None)


def replay_t_or_kernel(o, d, tris, index, t_kernel, hit):
    """The kernel's t where it hit, through `_ReplayTOrKernel` where a
    gradient is needed; the kernel's t as it is otherwise (a pure render
    skips the recompute)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (o, d, tris.v0, tris.v1, tris.v2)):
        return torch.where(hit, _ReplayTOrKernel.apply(
            o, d, tris.v0, tris.v1, tris.v2, index, t_kernel), t_kernel)
    return t_kernel


def hit_geometry(o, d, scene, kind, index, t):
    """Differentiable (point, normal) from the discrete hit structure
    (kind, index) and t (the JAX package's ops/pallas/megakernel.py::
    hit_geometry): the sphere normal from the gathered center, the
    triangle's geometric normal from its vertices, flipped toward the
    ray."""
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    point = o + d * t_safe[:, None]
    S = scene.spheres.mask.shape[0]
    sel = torch.where(kind == 1, index, 0)
    c = scene.spheres.center[torch.clamp(sel, max=S - 1)] * (
        sel < S).to(point.dtype)[:, None]
    n_sph = normalize(point - c)
    tr = scene.triangles
    idx_t = torch.clamp(torch.where(kind == 2, index, 0),
                        max=tr.v0.shape[0] - 1)
    e1 = tr.v1[idx_t] - tr.v0[idx_t]
    e2 = tr.v2[idx_t] - tr.v0[idx_t]
    n_tri = normalize(cross(e1, e2))
    n_tri = n_tri * torch.where(dot(n_tri, d)[:, None] > 0, -1.0, 1.0)
    normal = torch.where((kind == 2)[:, None], n_tri, n_sph)
    return point, normal


class Hits(NamedTuple):
    """Combined nearest-hit record: kind 0 = miss, 1 = sphere, 2 =
    triangle (the reference's hit_a_sphere / hit_a_triangle)."""

    kind: torch.Tensor  # [R] int64
    index: torch.Tensor  # [R] int64 (into spheres or triangles by kind)
    t: torch.Tensor  # [R]
    point: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3]


def _nearest_triangles(o, d, scene, quirks: Quirks, live) -> TriangleHits:
    """The triangle scan, routed as the module docstring says. The
    kernels are forward only: they get gradient-free inputs, and their t
    reaches rays and vertices through `replay_t_or_kernel`. K3 gives no
    barycentrics (u, v None)."""
    tr = scene.triangles
    if scene.clusters is not None and scene.clusters.n_clusters > 4:
        from skele_raytracer_tpu_torch.ops.cuda import culled

        mesh = (scene.clusters_fine
                if live is not None and scene.clusters_fine is not None
                else scene.clusters)
        t, idx, hit = culled.triangle_nearest_culled(
            o.detach(), d.detach(), mesh, quirks=quirks,
            live=None if live is None else live.detach())
        u = v = None
    elif tr.mask.shape[0] >= 64:
        from skele_raytracer_tpu_torch.ops.cuda import intersect as ik

        t, idx, hit, u, v = ik.triangle_nearest(
            o.detach(), d.detach(), tr.v0.detach(), tr.v1.detach(),
            tr.v2.detach(), tr.mask.detach(), quirks=quirks)
    else:
        return nearest_triangle(o, d, tr.v0, tr.v1, tr.v2, tr.mask,
                                quirks=quirks)
    t = replay_t_or_kernel(o, d, tr, idx, t, hit)
    return TriangleHits(t=t, index=idx, hit=hit, u=u, v=v)


def intersect(o, d, scene, *, quirks: Quirks, live=None) -> Hits:
    """Nearest hit over all scene primitives (the body of `shade`'s
    search, src/raytrace.h:146-187): spheres first, then triangles, where
    a triangle wins only with a strictly smaller t. `live` [R] (nonzero =
    the ray's result is used) marks a bounce wave: the culled kernel then
    takes the fine clustering and returns a miss for dead rays."""
    R = o.shape[0]
    if scene.has_spheres:
        sph = nearest_sphere(o, d, scene.spheres.center, scene.spheres.radius,
                             scene.spheres.mask, quirks=quirks)
    else:
        sph = SphereHits(
            t=torch.full((R,), INF, device=o.device),
            index=torch.zeros((R,), dtype=torch.int64, device=o.device),
            hit=torch.zeros((R,), dtype=torch.bool, device=o.device))
    if scene.has_triangles:
        tri = _nearest_triangles(o, d, scene, quirks, live)
        tri_wins = tri.hit & (tri.t < torch.where(sph.hit, sph.t, INF))
        kind = torch.where(tri_wins, 2, torch.where(sph.hit, 1, 0))
        index = torch.where(tri_wins, tri.index.to(torch.int64), sph.index)
        t = torch.where(tri_wins, tri.t, sph.t)
    else:
        kind = torch.where(sph.hit, 1, 0)
        index = sph.index
        t = sph.t

    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    point = o + d * t_safe[:, None]
    # Sphere normal: normalize(point - center) (src/raytrace.h:199-201).
    if scene.has_spheres:
        normal = normalize(point - scene.spheres.center[sph.index])
    else:
        normal = torch.zeros_like(point)
    if scene.has_triangles:
        # Triangle geometric normal from the scene's normal table, flipped
        # to face the incoming ray (parity shades triangles black, so it
        # is unused there). A miss's index may lie past the table (the
        # culled kernel clamps to the padded cluster length): clamp.
        n_tab = scene.tri_normals
        n_tri = n_tab[torch.clamp(tri.index.to(torch.int64),
                                  max=n_tab.shape[0] - 1)]
        n_tri = n_tri * torch.where(dot(n_tri, d) > 0, -1.0, 1.0)[:, None]
        normal = torch.where((kind == 2)[:, None], n_tri, normal)
    return Hits(kind=kind, index=index, t=t, point=point, normal=normal)


def shadow_occluded(point, to_light_dir, scene, *, quirks: Quirks):
    """Is the path from `point` toward `to_light_dir` blocked? (`shadow()`,
    src/utils.h:42-76: parity adds 1e-6 to every component of the origin
    and tests spheres only; clean callers pre-offset the origin along the
    normal and triangles occlude too. No max-t bound.)"""
    origin = point + SHADOW_ORIGIN_EPS if quirks.scalar_epsilon_offset else point
    direction = normalize(to_light_dir)
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    t_sph = ray_sphere_all(origin, direction, scene.spheres.center,
                           scene.spheres.radius, scene.spheres.mask,
                           t_clip=t_clip)
    occluded = torch.isfinite(t_sph).any(dim=1)
    if not quirks.sphere_only_shadows:
        tr = scene.triangles
        _, ok, _, _ = ray_triangle_all(origin, direction, tr.v0, tr.v1, tr.v2,
                                       tr.mask, quirks=quirks)
        occluded = occluded | ok.any(dim=1)
    return occluded

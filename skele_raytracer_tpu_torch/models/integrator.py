"""Wavefront integrator: the chunked path of the JAX package's
models/integrator.py, eager in PyTorch.

The reference integrator (src/raytrace.h:139-227) is a per-pixel recursion
whose Monte-Carlo branch spawns `num_path_traces` children at every level.
As in the JAX package it is an iterative wavefront over flat ray batches:

* bounce 0: one intersect + direct-illumination pass per pixel sample;
* bounces 1..D-1 (Monte-Carlo only): each sample carries `num_paths`
  linear continuation paths with a running throughput
  (L += T * (direct/pi) * diffuse; T *= 2*pi*r1*diffuse), averaged at the
  top. For depth <= 2 this equals the reference's exponential form per
  sample; deeper, in expectation.

Misses return the background at any depth (src/raytrace.h:190-193);
parity's triangle hits return black and stop (src/raytrace.h:221-224).

Each wave's nearest hit and direct light (`_shade_hit`) take one of two
routes, as in the JAX package:

* the split pipeline: `geometry.intersect` (spheres in plain torch,
  triangles through K3 or K5), shadows through K4 and eager Blinn-Phong
  (ops/shading.py). On the card without autograd (`_shade_kernels`) the
  tensor code after the scans runs as two glue kernels around K4
  (ops/cuda/glue.py): G3 for the hit record, the material and K4's shadow
  rays, G4 for the direct term. `COUNTERS["wavefront.shade"]` counts the
  split waves on the card by the route they took (`kernel`, `eager`);
* with `RenderConfig.fused_megakernel` on a clean mesh scene of more than
  4 clusters without fog (`_use_megakernel`), the fused kernel K7
  (ops/cuda/megakernel.py `fused_shade`): one launch per wave for the hit,
  the shadows and the direct term; the hit point and normal are then
  re-derived from its (kind, index, t) (`geometry.hit_geometry`) for the
  continuation rays. Like the split route's kernels, it runs its plain
  version on CPU tensors, so the gate does not look at the backend.

Clean non-Monte-Carlo frames take the Whitted frontier
(`integrate_whitted`): at each depth every frontier ray is shaded by the
same `_shade_hit` (so K3/K4, K5 or K7 serve each wave) and spawns a
reflection and a refraction child. The frontier doubles by concatenation
and is never compacted: children of weight 0 stay in the batch, and the
kernels skip them through the `live` mask. In a traced frame
`COUNTERS["wavefront.whitted"]` counts each depth's rows and the live
ones among them (utils/profiling.py `count_frontier`).
"""

from __future__ import annotations

import math

import torch

from skele_raytracer_tpu_torch.config import INDIRECT_ORIGIN_EPS, RenderConfig
from skele_raytracer_tpu_torch.ops import sampling
from skele_raytracer_tpu_torch.ops.geometry import (
    Hits,
    _nearest_triangles,
    dot,
    hit_geometry,
    intersect,
    nearest_sphere,
    normalize,
    offset_origin,
)
from skele_raytracer_tpu_torch.ops.shading import (
    _unpack_material,
    _uses_culled_shadows,
    direct_illumination,
    fresnel,
    gather_material,
    refraction,
)
from skele_raytracer_tpu_torch.utils import profiling

_PI = math.pi
_MASK = 0xFFFFFFFF
SHADE = profiling.COUNTERS["wavefront.shade"]


def _fog_uniforms(scene, cfg: RenderConfig, seed, ids, bounce):
    """Fog draws [R, L, F, 4, 2], or None without live fog (parity's
    zeroed fog needs none)."""
    if not scene.has_fog or scene.fog_zeroed:
        return None
    L = scene.point_lights.mask.shape[0]
    F = scene.fog.mask.shape[0]
    return sampling.uniform(seed, ids, bounce, sampling.PURPOSE_FOG,
                            (L, F, 4, 2))


def _use_megakernel(scene, cfg: RenderConfig) -> bool:
    """True when the fused kernel K7 serves this configuration (the JAX
    package's gate but for the backend): asked for, a clustered mesh of
    more than 4 clusters, no fog, every kernel-relevant quirk off."""
    q = cfg.quirks
    return (cfg.fused_megakernel
            and scene.has_triangles
            and scene.clusters is not None
            and scene.clusters.n_clusters > 4
            and not scene.has_fog
            and not (q.near_clip_t_le_1 or q.reference_triangle_test
                     or q.triangles_shade_black or q.sphere_only_shadows
                     or q.scalar_epsilon_offset))


def _glue_serves(scene, cfg: RenderConfig) -> bool:
    """True when the glue kernels G3 and G4 compute what the split route's
    tensor code does for this scene and configuration: no live fog (its
    draws and `_fog_term` stay tensor code) and, with shadows, every
    triangle shadow through K4 (a mesh of 4 clusters or fewer has its
    shadows scanned brute force by `ray_triangle_all`)."""
    q = cfg.quirks
    if scene.has_fog and not scene.fog_zeroed:
        return False
    return not (cfg.use_shadows and scene.has_triangles
                and not q.sphere_only_shadows
                and not _uses_culled_shadows(scene, q))


def _shade_kernels(scene, cfg: RenderConfig, o, d) -> bool:
    """True when the split route's hit shading runs as G3 and G4: CUDA
    tensors that need no gradient, where `_glue_serves`."""
    return (o.device.type == "cuda" and _glue_serves(scene, cfg)
            and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (o, d, *scene.tensors()))))


def _shade_hit_glue(scene, cfg: RenderConfig, o, d, live):
    """`_shade_hit`'s split route through G3, K4 and G4: the scans as the
    tensor route runs them, then G3; K4 on G3's shadow rays toward the
    point, then the directional lights; G4 (ops/cuda/glue.py)."""
    from skele_raytracer_tpu_torch.ops.cuda import culled, glue

    quirks = cfg.quirks
    sph = (nearest_sphere(o, d, scene.spheres.center, scene.spheres.radius,
                          scene.spheres.mask, quirks=quirks)
           if scene.has_spheres else None)
    tri = (_nearest_triangles(o, d, scene, quirks, live)[:3]
           if scene.has_triangles else None)
    k4 = cfg.use_shadows and _uses_culled_shadows(scene, quirks)
    g = glue.shade_hit_kernel(o, d, live, sph, tri, scene, cfg, k4=k4)
    mesh = (scene.clusters_fine
            if live is not None and scene.clusters_fine is not None
            else scene.clusters)
    occ = [None if feats is None else culled.occluded_features(
        feats, bound, mesh, quirks=quirks,
        live=g.k4_live[:bound.shape[0]])
        for feats, bound in ((g.feats_p, g.bound_p), (g.feats_d, g.bound_d))]
    direct = glue.shade_direct_kernel(g, *occ)
    hits = Hits(kind=g.kind, index=g.index, t=g.t, point=g.point,
                normal=g.normal)
    return hits, _unpack_material(g.mat), direct, g.shades, g.miss


def _shade_hit(scene, cfg: RenderConfig, seed, o, d, ids, bounce, live=None):
    """Nearest hit + direct illumination of a ray batch. `live` [R]
    (1.0 where the ray still carries throughput) marks a bounce wave.

    Returns (hits, mat, direct [R, 3], shades [R] bool: the hit shades
    (spheres always, triangles in clean mode), miss [R] bool)."""
    quirks = cfg.quirks
    if _use_megakernel(scene, cfg):
        from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk

        direct, t, kind, index, _ = mk.fused_shade(o, d, scene,
                                                   cfg.use_shadows, live)
        point, normal = hit_geometry(o, d, scene, kind, index, t)
        hits = Hits(kind=kind, index=index, t=t, point=point, normal=normal)
        mat = gather_material(scene, kind, index, quirks=quirks)
        return hits, mat, direct, kind > 0, kind == 0
    if _shade_kernels(scene, cfg, o, d):
        SHADE["kernel"] += 1
        return _shade_hit_glue(scene, cfg, o, d, live)
    if o.is_cuda:
        SHADE["eager"] += 1
    hits = intersect(o, d, scene, quirks=quirks, live=live)
    kind, index = hits.kind, hits.index
    # shadow rays matter only for rays that hit and carry throughput
    live_sh = (kind > 0).to(torch.float32)
    if live is not None:
        live_sh = live_sh * live

    mat = gather_material(scene, kind, index, quirks=quirks)
    if scene.has_fog and not scene.fog_zeroed:
        S = scene.spheres.mask.shape[0]
        prim_center = (scene.spheres.center[torch.clamp(index, max=S - 1)]
                       * (index < S).to(torch.float32)[:, None])
        if not quirks.triangles_shade_black:
            prim_center = torch.where((kind == 2)[:, None], hits.point,
                                      prim_center)
    else:
        prim_center = hits.point  # unused downstream

    fog_u = _fog_uniforms(scene, cfg, seed, ids, bounce)
    direct = direct_illumination(hits.point, hits.normal, scene, mat,
                                 prim_center, cfg, fog_u, live=live_sh,
                                 incoherent=live is not None)
    shades = kind == 1
    if not quirks.triangles_shade_black:
        shades = shades | (kind == 2)
    return hits, mat, direct, shades, kind == 0


def _mc_continue(scene, cfg: RenderConfig, seed, hits, mat, ids, bounce):
    """The Monte-Carlo continuation ray at each hit
    (montecarlo_global_illumination's per-path body, src/raytrace.h:
    117-131): (o', d', factor [R, 3] = 2*pi*r1*diffuse)."""
    quirks = cfg.quirks
    r = sampling.uniform(seed, ids, bounce, sampling.PURPOSE_PATH, (2,))
    r1, r2 = r[:, 0], r[:, 1]
    d_new = sampling.to_world(sampling.uniform_sample_hemi(r1, r2),
                              hits.normal, quirks=quirks)
    if not quirks.unnormalized_ray_dirs:
        d_new = normalize(d_new)
    if quirks.scalar_epsilon_offset:
        o_new = hits.point + INDIRECT_ORIGIN_EPS  # src/raytrace.h:128
    else:
        o_new = offset_origin(hits.point, hits.normal)
    factor = 2.0 * _PI * r1[:, None] * mat.diffuse
    return o_new, d_new, factor


def _repeat_rows(x, P: int):
    return torch.repeat_interleave(x, P, dim=0)


def integrate_linear(scene, cfg: RenderConfig, seed, o, d, sample_ids):
    """Radiance [C, 3] of primary rays [C]: parity semantics, and clean
    Monte-Carlo path tracing. sample_ids [C]: the global sample ids (RNG
    counters, values in [0, 2^32))."""
    P = cfg.paths_per_sample
    with profiling.span("wave", 0):
        hits, mat, direct, shades, miss = _shade_hit(scene, cfg, seed, o, d,
                                                     sample_ids, 0)
    background = scene.background[None, :].expand_as(direct)

    if not cfg.monte_carlo:
        # Plain Blinn-Phong: direct for shaded hits, black triangles,
        # background misses (src/raytrace.h:205-218).
        return torch.where(miss[:, None], background,
                           torch.where(shades[:, None], direct, 0.0))

    l0 = torch.where(miss[:, None], background,
                     torch.where(shades[:, None], direct / _PI * mat.diffuse,
                                 0.0))
    if cfg.max_depth <= 1:
        return l0  # continuations would shade at depth 0: black

    # Each sample expands into P linear continuation paths.
    C = o.shape[0]
    ids64 = sample_ids.to(torch.int64)
    path_ids = ((ids64[:, None] * P + torch.arange(P, device=o.device)[None, :])
                & _MASK).reshape(-1)
    hits_p = type(hits)(*(_repeat_rows(x, P) for x in hits))
    mat_p = type(mat)(*(_repeat_rows(x, P) for x in mat))
    o_b, d_b, f = _mc_continue(scene, cfg, seed, hits_p, mat_p, path_ids, 0)
    t_b = f * _repeat_rows(shades, P)[:, None]  # only shaded hits continue

    path_l = torch.zeros_like(t_b)
    for bounce in range(1, cfg.max_depth):
        live = (t_b != 0).any(dim=1).to(torch.float32)
        with profiling.span("wave", bounce):
            h, m, dir_b, sh, ms = _shade_hit(scene, cfg, seed, o_b, d_b,
                                             path_ids, bounce, live)
        bg = scene.background[None, :].expand_as(dir_b)
        path_l = path_l + t_b * torch.where(
            ms[:, None], bg,
            torch.where(sh[:, None], dir_b / _PI * m.diffuse, 0.0))
        # The final bounce's continuation is never traced (shade at depth
        # 0 is black, src/raytrace.h:142): it is not sampled.
        if bounce < cfg.max_depth - 1:
            o_b, d_b, f = _mc_continue(scene, cfg, seed, h, m, path_ids,
                                       bounce)
            t_b = t_b * f * sh[:, None]
    return l0 + path_l.reshape(C, P, 3).mean(dim=1)


def integrate_whitted(scene, cfg: RenderConfig, seed, o, d, sample_ids):
    """Radiance [C, 3] of primary rays [C] in clean non-Monte-Carlo mode:
    the reference's dead reflection/refraction code (src/raytrace.h:46-103,
    unreachable behind the early return at :44) as a breadth-first
    frontier, as in the JAX package.

    Each hit with nonzero specular and depth left spawns a reflection
    child (reflect the view ray, weight specular * (1 - fresnel)) and a
    refraction child (bp::refraction, weight fresnel, when fresnel < 1
    and the refracted direction is not the zero sentinel). The frontier
    doubles by concatenation [reflection; refraction]: rows i, i+C,
    i+2C, ... belong to sample i. Children keep distinct RNG streams:
    ids*2 and ids*2+1 modulo 2^32, the JAX package's uint32."""
    C = o.shape[0]
    frontier_o, frontier_d = o, d
    weight = torch.ones_like(o)
    total = torch.zeros_like(o)
    ids = sample_ids.to(torch.int64)
    counting = profiling.counting()

    for depth in range(cfg.max_depth):
        live = (weight != 0).any(dim=1).to(torch.float32)
        with profiling.span("wave", depth):
            hits, mat, direct, shades, miss = _shade_hit(
                scene, cfg, seed, frontier_o, frontier_d, ids, depth, live)
        bg = scene.background[None, :].expand_as(direct)
        l_local = torch.where(miss[:, None], bg,
                              torch.where(shades[:, None], direct, 0.0))
        total = total + _fold(weight * l_local, C)
        if counting:
            profiling.count_frontier(depth, live, shades)
        if depth == cfg.max_depth - 1:
            break

        with profiling.span("whitted.spawn", depth):
            d_hat = normalize(frontier_d)
            fr = fresnel(d_hat, hits.normal, mat.ior)
            has_spec = (mat.specular != 0.0).any(dim=-1) & shades
            o_refl = offset_origin(hits.point, hits.normal)
            refl_d = (d_hat
                      - 2.0 * dot(d_hat, hits.normal)[:, None] * hits.normal)
            refl_w = (weight * mat.specular * (1.0 - fr)[:, None]
                      * has_spec[:, None])
            refr_d = refraction(d_hat, hits.normal, mat.ior)
            refr_valid = has_spec & (fr < 1.0) & (dot(refr_d, refr_d) > 0)
            refr_w = weight * fr[:, None] * refr_valid[:, None]
            # refraction continues on the far side of the surface
            o_refr = offset_origin(hits.point, hits.normal, sign=-1.0)

            frontier_o = torch.cat([o_refl, o_refr])
            frontier_d = torch.cat([refl_d, refr_d])
            weight = torch.cat([refl_w, refr_w])
            ids = torch.cat([(ids * 2) & _MASK, (ids * 2 + 1) & _MASK])
    return total


def _fold(contrib, n: int):
    """Sum a [k*n, 3] frontier contribution back onto its n samples
    (rows i, i+n, i+2n, ... belong to sample i)."""
    return contrib.reshape(-1, n, 3).sum(dim=0)


def integrate(scene, cfg: RenderConfig, seed, o, d, sample_ids):
    """Monte-Carlo / parity -> the linear wavefront; clean non-MC with
    reflections -> the Whitted frontier."""
    if cfg.monte_carlo or cfg.quirks.disable_reflections:
        return integrate_linear(scene, cfg, seed, o, d, sample_ids)
    return integrate_whitted(scene, cfg, seed, o, d, sample_ids)

"""The plain reference of the Whitted frontier: radiance of flat sample
ids in clean semantics without Monte-Carlo paths, each hit's reflection
and refraction followed to the configuration's depth.

Written from the upstream's reflection/refraction code, which its early
return makes dead (lilinitsy/skele-raytracer src/raytrace.h:46-103),
`bp::fresnel` (src/blinn_phong.h:156-184: full Fresnel, Rs and Rp over
one denominator, the indices swapped when cos > 0, 1 where sin t >= 1)
and `bp::refraction` (:143-153: k = 1 - ior^2 (1 - (n.d)^2), the zero
vector where k < 0, no swap of the indices inside a surface). At each
depth every ray takes the local radiance, the background on a miss and
the direct light (`render.direct`: ambient + Blinn-Phong of every light,
shadows as configured) on a hit, times its weight. A hit whose specular
is not zero spawns, while depth is left,

* a reflection child, the view ray mirrored about the normal, of weight
  weight x specular x (1 - fresnel);
* a refraction child, of weight weight x fresnel, where fresnel < 1 and
  the refracted direction is not the zero vector.

The program's published conventions where the upstream leaves a choice
open:

* the clean near clip (render.CLEAN_T_EPS) for every hit, primary or
  not, through `render.intersect`;
* a child's origin off the surface along the normal by CLEAN_T_EPS x
  (1 + |p|): a reflection child on the normal's side, a refraction child
  on the far side;
* the view ray's direction normalized before it is mirrored or refracted;
  the refracted direction as `bp::refraction` leaves it;
* children's sample ids 2i (reflection) and 2i + 1 (refraction) modulo
  2^32, the draws' counters, with the depth as the draws' bounce (fog).

The frontier is breadth-first: depth by depth, every ray of the depth
against every primitive (`render.intersect`, brute force in blocks). A
child of weight 0 adds nothing and is not followed. It imports nothing of
the program; `dtype` sets the precision of all floating-point work, so
the same code is the reference (float32) and its control (bfloat16).
"""

from __future__ import annotations

import torch

from perfbench.reference import render

MASK32 = render.MASK32


def offset(p, n, sign: float):
    """A child's origin: off the surface by CLEAN_T_EPS (1 + |p|) along
    sign x the normal."""
    return p + (sign * render.CLEAN_T_EPS * (1.0 + render.norm(p)[:, None])
                ) * n


def ior_at(scene, kind, index):
    """[R] index of refraction of each hit's material (1 on a miss)."""
    out = torch.ones(kind.shape, dtype=scene.ambient.dtype,
                     device=kind.device)
    for grp, k in ((scene.spheres, 1), (scene.triangles, 2)):
        if grp:
            rows = grp["ior"][torch.clamp(index, max=grp["ior"].shape[0] - 1)]
            out = torch.where(kind == k, rows, out)
    return out


def fresnel(d, n, ior):
    """bp::fresnel of unit view directions d at normals n: [R]."""
    cosi = torch.clamp(render.dot(d, n), -1.0, 1.0)
    swap = cosi > 0
    etai = torch.where(swap, ior, 1.0)
    etat = torch.where(swap, 1.0, ior)
    sint = etai / etat * render.pos_sqrt(1.0 - cosi * cosi)
    cost = render.pos_sqrt(1.0 - sint * sint)
    cosi = torch.abs(cosi)
    den = etat * cosi + etai * cost
    den = torch.where(den.abs() > 1e-30, den, 1e-30)
    rs = (etat * cosi - etai * cost) / den
    rp = (etai * cosi - etat * cost) / den
    return torch.where(sint >= 1.0, 1.0, (rs * rs + rp * rp) / 2.0)


def refraction(d, n, ior):
    """bp::refraction: [R, 3], the zero vector where k < 0."""
    dn = render.dot(d, n)[:, None]
    eta = ior[:, None]
    k = 1.0 - eta * eta * (1.0 - dn * dn)
    out = eta * d - (eta * dn + render.pos_sqrt(k)) * n
    return torch.where(k < 0, 0.0, out)


def radiance(scene, cfg: render.Config, seed, ids, dtype=torch.float32):
    """[N, 3] radiance of flat sample ids, the frontier followed to
    cfg.depth."""
    assert not cfg.parity and cfg.gillum <= 0, "clean, without paths"
    o, d = render.camera_rays(scene, cfg, seed, ids, dtype)
    owner = torch.arange(ids.shape[0], device=ids.device)
    rid = ids.to(torch.int64) & MASK32
    weight = torch.ones_like(o)
    total = torch.zeros_like(o)
    for depth in range(cfg.depth):
        kind, index, _, x, n = render.intersect(scene, cfg, o, d)
        n = n.to(x.dtype)  # a flipped triangle normal comes out in float32
        mat = render.material(scene, cfg, kind, index)
        lit = render.direct(scene, cfg, seed, rid, depth, kind, index, x, n,
                            mat)
        local = torch.where((kind == 0)[:, None], scene.background[None, :],
                            lit)
        total = total.index_add(0, owner, weight * local)
        if depth == cfg.depth - 1:
            break
        d_hat = render.normalize(d)
        ior = ior_at(scene, kind, index)
        fr = fresnel(d_hat, n, ior)
        spec = (mat["specular"] != 0).any(1) & (kind > 0)
        w_refl = weight * mat["specular"] * (1.0 - fr)[:, None] * spec[:, None]
        d_refl = d_hat - 2.0 * render.dot(d_hat, n)[:, None] * n
        d_refr = refraction(d_hat, n, ior)
        ok = spec & (fr < 1.0) & (render.dot(d_refr, d_refr) > 0)
        w_refr = weight * fr[:, None] * ok[:, None]
        a, b = (w_refl != 0).any(1), (w_refr != 0).any(1)
        o = torch.cat([offset(x, n, 1.0)[a], offset(x, n, -1.0)[b]])
        d = torch.cat([d_refl[a], d_refr[b]])
        weight = torch.cat([w_refl[a], w_refr[b]])
        owner = torch.cat([owner[a], owner[b]])
        rid = torch.cat([(rid[a] * 2) & MASK32, (rid[b] * 2 + 1) & MASK32])
        if o.shape[0] == 0:
            break
    return total


def render_pixels(scene, cfg: render.Config, seed, pixels,
                  dtype=torch.float32, block=1 << 14):
    """[len(pixels), 3]: each pixel's samples averaged, as a frame holds
    it, in blocks of `block` samples."""
    # nothing here is a matrix product; TF32 stays off all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spp = cfg.spp
    ids = (pixels.to(torch.int64)[:, None] * spp
           + torch.arange(spp, device=pixels.device)[None, :]).reshape(-1)
    out = torch.cat([radiance(scene, cfg, seed, ids[i:i + block], dtype)
                     for i in range(0, ids.shape[0], block)])
    return out.reshape(-1, spp, 3).mean(1)

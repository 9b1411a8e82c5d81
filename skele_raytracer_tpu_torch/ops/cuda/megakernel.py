"""Fused intersect + shadow + Blinn-Phong kernel K7: host side, plain
PyTorch version, the CUDA kernel's wrapper and its differentiable replay.

The counterpart of the JAX package's `ops/pallas/megakernel.py`
(`_pack_shade_planes`, `fused_shade_forward`, `shade_replay`,
`fused_shade`). The integrator sends a wave here when
`RenderConfig.fused_megakernel` is set on a clean mesh scene of more than 4
clusters without fog (models/integrator.py `_use_megakernel`): one launch
per wave computes each ray's nearest hit (triangles over the coarse
clustering, spheres), the hit data, each light's shadow bit and the clean
Blinn-Phong direct term.

`fused_shade_forward` sorts the rays by the spatial key of ops/cuda/
culled.py (dead rays last), runs the kernel (csrc/megakernel.cu: several
lanes per ray, as K3, with ops/cuda/culled.py `launch_shape`'s launch
arithmetic) on CUDA tensors or its plain version `fused_shade_torch` on
CPU tensors, and unsorts. Every table the kernel reads is packed from the
scene on each call (`pack_shade_table` from the current vertices), so
nothing goes stale when a fit moves the triangles. A live ray's outputs
depend on neither the ray order, the tiling nor `live`; dead rays get the
defaults (direct 0, t inf, kind 0, index 0, unshadowed 1). The JAX kernel
writes defaults only for tiles that are dead as a whole, so the two
packages are compared with `live=None`.

`fused_shade_torch` is the kernel's contract done brute force over every
clustered record, the formulas of csrc/fused_math.cuh in the same order:
sphere occlusion for every live ray, triangle occlusion only for hit rays
of unmasked lights, as the TPU kernel computes them.

`fused_shade` is differentiable (a `torch.autograd.Function`, the JAX
package's custom_vjp): the forward value is the kernel's, the backward the
gradient of `shade_replay` (plain PyTorch, O(rays): the t of the recorded
primitive, the hit data and the shading, with the saved unshadowed bits as
constant gates) at the saved (kind, index, unshadowed), for `direct` and
`t`. A pure render runs no replay; `live` carries no gradient.

Not ported: the TPU's VMEM-resident and DMA-streaming variants
(`RESIDENT_BUDGET_BYTES`, `mesh_resident_bytes`): the card has one mode,
records staged from L2 into shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from skele_raytracer_tpu_torch.config import CLEAN_T_EPS
from skele_raytracer_tpu_torch.ops.cuda import culled, glue
from skele_raytracer_tpu_torch.ops.cuda._build import check_outputs
from skele_raytracer_tpu_torch.ops.cuda.intersect import (
    BIG,
    REC,
    _brute_t,
    first_min,
    planes_torch,
    sphere_t_all_torch,
    sqrt_rn,
)
from skele_raytracer_tpu_torch.ops.geometry import (
    _pos_sqrt,
    cross,
    dot,
    normalize,
    replay_triangle_t,
)
from skele_raytracer_tpu_torch.utils import profiling

SROW, TROW, LROW = 16, 14, 7  # csrc/fused_math.cuh row widths

# Launches of the kernel, counted where the wrapper launches it.
LAUNCHES = {"fused_shade": 0}
profiling.COUNTERS["launches"]["megakernel"] = LAUNCHES

# The scene leaves the replay reads (dotted paths of scene.types
# leaf_items), in the order `_FusedShade` takes them.
REPLAY_LEAVES = (
    "spheres.center", "spheres.radius", "spheres.ambient", "spheres.diffuse",
    "spheres.specular", "spheres.power", "triangles.v0", "triangles.v1",
    "triangles.v2", "triangles.ambient", "triangles.diffuse",
    "triangles.specular", "triangles.power", "point_lights.position",
    "point_lights.colour", "point_lights.mask",
    "directional_lights.direction", "directional_lights.colour",
    "directional_lights.mask", "camera.position", "ambient")


# ---------------------------------------------------------------------------
# Tables (csrc/fused_math.cuh layouts)
# ---------------------------------------------------------------------------


def pack_shade_table(tris):
    """[T, 14] by original triangle index: the unit normal
    normalize(cross(v1 - v0, v2 - v0)), ambient, diffuse, specular, power,
    ior (the JAX package's `_pack_shade_planes`, unsorted)."""
    n = normalize(cross(tris.v1 - tris.v0, tris.v2 - tris.v0))
    return torch.cat([n, tris.ambient, tris.diffuse, tris.specular,
                      tris.power[:, None], tris.ior[:, None]], dim=1
                     ).contiguous()


def pack_sphere_rows(sph):
    """[S, 16]: center, |c|^2 - r^2, mask, ambient, diffuse, specular,
    power, ior."""
    cc = dot(sph.center, sph.center) - sph.radius * sph.radius
    return torch.cat([sph.center, cc[:, None], sph.mask[:, None],
                      sph.ambient, sph.diffuse, sph.specular,
                      sph.power[:, None], sph.ior[:, None]], dim=1
                     ).contiguous()


def pack_lights(scene):
    """([Lp + Ld, 7], Lp): point lights (position, colour, mask), then
    directional lights with their direction made unit on the host."""
    pl, dl = scene.point_lights, scene.directional_lights
    dn = torch.sqrt(torch.clamp(dot(dl.direction, dl.direction), min=1e-30))
    unit = dl.direction / dn[:, None]
    rows = torch.cat([
        torch.cat([pl.position, pl.colour, pl.mask[:, None]], dim=1),
        torch.cat([unit, dl.colour, dl.mask[:, None]], dim=1)])
    return rows.contiguous(), pl.mask.shape[0]


def pack_tables(scene):
    """(shade, spheres, lights, Lp, cnst): every table the kernel reads
    besides the clustered records, from the scene as it is now."""
    lights, n_point = pack_lights(scene)
    cnst = torch.cat([scene.camera.position, scene.ambient]).contiguous()
    return (pack_shade_table(scene.triangles),
            pack_sphere_rows(scene.spheres), lights, n_point, cnst)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _unit(v):
    """csrc/fused_math.cuh `unit`: v * (1 / sqrt(|v|^2)), 0 for v = 0."""
    n2 = dot(v, v)
    pos = n2 > 0
    inv = torch.ones_like(n2) / sqrt_rn(torch.where(pos, n2, 1.0)) * pos
    return v * inv[:, None]


def _nearest_brute(feats, rec):
    """(t [R] (BIG = miss), original index [R] int64 (BIG_I on a miss)):
    the clean brute_t over every record, the lexicographic minimum of (t,
    index) over hits (mesh_math.cuh `nearest_update`)."""
    orig = rec[:, REC - 1].to(torch.int64)
    starts, step = culled._chunks(feats.shape[0], rec.shape[0], feats.device)
    ts, idxs = [], []
    for r0 in starts:
        t_all = _brute_t(*planes_torch(feats[r0:r0 + step], rec, -1.0),
                         True)[0]
        t = t_all.amin(dim=1)
        idx = torch.where(t_all == t[:, None], orig[None, :],
                          culled.BIG_I).amin(1)
        ts.append(t)
        idxs.append(torch.where(t < BIG, idx, culled.BIG_I))
    return torch.cat(ts), torch.cat(idxs)


def _blocked(feats, rec, bound):
    """[R] bool: does any record's clean t fall below `bound` [R]
    (fused_math.cuh `blocks`)?"""
    starts, step = culled._chunks(feats.shape[0], rec.shape[0], feats.device)
    out = [(_brute_t(*planes_torch(feats[r0:r0 + step], rec, -1.0), True)[0]
            < bound[r0:r0 + step, None]).any(dim=1) for r0 in starts]
    return torch.cat(out) if out else bound.new_zeros((0,), dtype=torch.bool)


def fused_shade_torch(feats, live, rec, shade, sph, lights, n_point: int,
                      cnst, *, use_shadows: bool):
    """Plain version of K7: (direct [R, 3], t [R] (BIG = miss), kind [R]
    int32, index [R] int32, unshadowed [R, L]) of features [R, 10] against
    every record of `rec` [..., 20] and the tables of `pack_tables`. Dead
    rays (live == 0) get the defaults."""
    rec = rec.reshape(-1, REC)
    R, T, L = feats.shape[0], shade.shape[0], lights.shape[0]
    dev = feats.device
    direct_out = torch.zeros((R, 3), device=dev)
    t_out = torch.full((R,), BIG, device=dev)
    kind_out = torch.zeros((R,), dtype=torch.int32, device=dev)
    index_out = torch.zeros((R,), dtype=torch.int32, device=dev)
    unsh_out = torch.ones((R, L), device=dev)
    rows = (torch.arange(R, device=dev) if live is None
            else (live != 0).nonzero()[:, 0])
    if rows.numel() == 0:
        return direct_out, t_out, kind_out, index_out, unsh_out
    f = feats[rows]
    d, o = f[:, 0:3], f[:, 6:9]

    # the two scans and the hit data (fused_math.cuh `surface`)
    t_tri, i_tri = _nearest_brute(f, rec)
    i_tri = torch.clamp(i_tri, max=T - 1)
    t_sph, i_sph = first_min(sphere_t_all_torch(o, d, sph, CLEAN_T_EPS))
    i_sph = i_sph.to(torch.int64)
    tri_wins = (t_tri < BIG) & (t_tri < t_sph)
    kind = torch.where(tri_wins, 2, torch.where(t_sph < BIG, 1, 0))
    index = torch.where(tri_wins, i_tri, i_sph)
    t = torch.where(tri_wins, t_tri, t_sph)
    shades = (kind > 0).to(torch.float32)
    x = o + d * torch.where(t < BIG, t, 0.0)[:, None]
    srow, trow = sph[i_sph], shade[i_tri]
    n_tri = trow[:, 0:3]
    n_tri = torch.where((dot(n_tri, d) > 0)[:, None], -n_tri, n_tri)
    normal = torch.where(tri_wins[:, None], n_tri, _unit(x - srow[:, 0:3]))
    mat = torch.where(tri_wins[:, None], trow[:, 3:14], srow[:, 5:16])
    amb, dif, spec, power = mat[:, 0:3], mat[:, 3:6], mat[:, 6:9], mat[:, 9]
    view = _unit(cnst[None, 0:3] - x)
    direct = cnst[None, 3:6] * amb
    xn2 = dot(x, x)
    pos = xn2 > 0
    xlen = sqrt_rn(torch.where(pos, xn2, 1.0)) * pos
    sh = x + (CLEAN_T_EPS * (1.0 + xlen))[:, None] * normal

    # lights in order: the shadow bit, then the Blinn-Phong term
    hit = kind > 0
    unsh_cols = []
    for li in range(L):
        lr = lights[li]
        point = li < n_point
        if point:
            v = lr[None, 0:3] - x
            d2 = dot(v, v)
            dl = sqrt_rn(torch.clamp(d2, min=1e-30))
            ldir = v / torch.clamp(dl, min=1e-30)[:, None]
            bound = dl
            falloff = torch.ones_like(d2) / torch.clamp(d2, min=1e-30)
        else:
            ldir = lr[None, 0:3].expand(f.shape[0], 3)
            bound = torch.full_like(t, BIG)
        occ = torch.zeros_like(hit)
        if use_shadows:
            occ = (sphere_t_all_torch(sh, ldir, sph, CLEAN_T_EPS)
                   < bound[:, None]).any(dim=1)
            if float(lr[6]) > 0:
                need = (hit & ~occ).nonzero()[:, 0]
                ld, so = ldir[need], sh[need]
                fs = torch.cat([ld, cross(so, ld), so,
                                torch.ones_like(bound[need])[:, None]], dim=1)
                occ[need] = _blocked(fs, rec, bound[need])
        unsh = (~occ).to(torch.float32)
        unsh_cols.append(unsh)
        gate = lr[6] * unsh * shades
        ndotl = torch.clamp(dot(normal, ldir), min=0.0)
        h = _unit(view + ldir)
        ndoth = torch.clamp(dot(normal, h), min=0.0)
        sp = torch.pow(torch.clamp(ndoth, min=1e-30), power) * (ndoth > 0)
        w = gate[:, None] * lr[None, 3:6]
        if point:
            w = w * falloff[:, None]
        direct = direct + w * (dif * ndotl[:, None] + spec * sp[:, None])

    direct_out[rows] = direct
    t_out[rows] = t
    kind_out[rows] = kind.to(torch.int32)
    index_out[rows] = index.to(torch.int32)
    if L:
        unsh_out[rows] = torch.stack(unsh_cols, dim=1)
    return direct_out, t_out, kind_out, index_out, unsh_out


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_lib = None


def bind(lib):
    """Declares `fused_shade` of a loaded library. Its C signature has not
    changed since the kernel was first ported but for the device
    counters' row, last, after the stream, so a library built from an
    earlier tree binds too: its launcher ignores that trailing
    argument."""
    lib.fused_shade.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 17
    lib.fused_shade.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (if needed) and load the CUDA kernel library."""
    global _lib
    if _lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        lib = bind(load_cuda("megakernel"))
        lib.fused_shade_lanes.argtypes = ([ctypes.c_int] * 9
                                          + [ctypes.c_void_p] * 17)
        lib.fused_shade_lanes.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_operands(feats, live, mesh, tables):
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"fused_shade kernel: CUDA tensors, got {dev}")
    lo, hi, root = mesh.kernel_boxes(mirrored=False)
    for x in [feats, mesh.rec, lo, hi, root, *tables] + (
            [] if live is None else [live]):
        if (x.device != dev or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"fused_shade kernel: contiguous float32 "
                             f"operands on {dev}, got {x.dtype} on "
                             f"{x.device}")
    R = feats.shape[0]
    shade, sph, lights, cnst = tables
    shapes = [(feats, (R, 10), "feats [R, 10]"),
              (shade, (shade.shape[0], TROW), "shade [T, 14]"),
              (sph, (sph.shape[0], SROW), "spheres [S, 16]"),
              (lights, (lights.shape[0], LROW), "lights [L, 7]"),
              (cnst, (6,), "cnst [6]")] + (
                  [] if live is None else [(live, (R,), "live [R]")])
    for x, want, name in shapes:
        if tuple(x.shape) != want:
            raise ValueError(f"fused_shade kernel: {name}, got "
                             f"{tuple(x.shape)}")
    if shade.shape[0] < 1 or sph.shape[0] < 1 or sph.shape[0] > 1024:
        raise ValueError("fused_shade kernel: 1 to 1,024 sphere rows and at "
                         "least one triangle")
    if mesh.rec.data_ptr() % 16:
        raise ValueError("fused_shade kernel: triangle records must be "
                         "16-byte aligned")
    if R >= 2**31:
        raise ValueError("fused_shade kernel: fewer than 2^31 rays")
    return lo, hi, root


@profiling.spanned("launch.k7")
def fused_shade_kernel(feats, live, mesh, shade, sph, lights, n_point: int,
                       cnst, *, use_shadows: bool, lanes: int | None = None):
    """K7 on CUDA tensors: the outputs of `fused_shade_torch` (with the
    clustered mesh `mesh` in place of its records); counted in
    LAUNCHES["fused_shade"], and while spans record in the device counters
    (`profiling.walk_counters`: the primary walk's rays, live rays and
    pairs, and each shadow walk's pairs). `lanes`: lanes per ray (one of
    culled.LANES) in place of the launcher's own choice, for
    measurements."""
    lo, hi, root = _check_operands(feats, live, mesh,
                                   (shade, sph, lights, cnst))
    lib = build_kernel()
    R, L, dev = feats.shape[0], lights.shape[0], feats.device
    culled.launch_shape(R, mesh.n_clusters, mesh.cluster_size, lanes,
                        extra_floats=sph.shape[0] * SROW + L * LROW + 6)
    direct = torch.empty((R, 3), dtype=torch.float32, device=dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    kind = torch.empty(R, dtype=torch.int32, device=dev)
    index = torch.empty(R, dtype=torch.int32, device=dev)
    unsh = torch.empty((R, L), dtype=torch.float32, device=dev)
    args = (R, mesh.n_clusters, mesh.cluster_size, shade.shape[0],
            sph.shape[0], n_point, L, int(use_shadows), feats.data_ptr(),
            None if live is None else live.data_ptr(),
            *(x.data_ptr() for x in (mesh.rec, lo, hi, root, shade, sph,
                                     lights, cnst, direct, t, kind, index,
                                     unsh)))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        ctr = profiling.walk_counters(dev, "k7")
        err = (lib.fused_shade(*args, stream, ctr) if lanes is None
               else lib.fused_shade_lanes(lanes, *args, stream, ctr))
    if err != 0:
        raise RuntimeError(f"fused_shade kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["fused_shade"] += 1
    check_outputs("fused_shade", direct, t, kind, index, unsh)
    return direct, t, kind, index, unsh


def spatial_keys_torch(o, d, mesh, live=None):
    """The keys `sort_rays` sorts by, in int64 tensor ops: the spatial key
    of ops/cuda/culled.py over the mesh's box, or where `live` (float32 [R])
    is given, that key >> 1 and culled._DEAD where `live` is not > 0. The
    plain version of the sort-key kernel's spatial mode (ops/cuda/glue.py).
    """
    keys = culled._spatial_sort_keys(o, d, mesh.aabb_lo.amin(0),
                                     mesh.aabb_hi.amax(0))
    if live is not None:
        keys = torch.where(live > 0, keys >> 1, culled._DEAD)
    return keys


@profiling.spanned("sort")
def sort_rays(o, d, mesh, live=None):
    """(order, live in that order or None): the rays sorted by the spatial
    key of ops/cuda/culled.py over the mesh's box, dead rays last (the JAX
    package's fused_shade_forward order). The keys come from the sort-key
    kernel on CUDA tensors and from `spatial_keys_torch` elsewhere."""
    if o.device.type == "cuda":
        table = mesh.sort_table(mirrored=False)
        keys = glue.sort_keys_kernel(o, d, table, live, mode=glue.KEY_SPATIAL)
    else:
        keys = spatial_keys_torch(o, d, mesh, live)
    order = torch.sort(keys, stable=True).indices
    return order, None if live is None else live[order].contiguous()


def fused_shade_forward(o, d, scene, *, use_shadows: bool, live=None,
                        reorder: bool = True):
    """(direct [R, 3], t [R] (inf = miss), kind [R] int64, index [R] int64,
    unshadowed [R, Lp + Ld]) of rays o, d through K7 (CUDA tensors) or its
    plain version (CPU tensors). Forward only. `live` [R]: nonzero where
    the ray still carries throughput; dead rays get the defaults.
    `reorder` sorts the rays by the spatial key first, dead rays last
    (results do not change)."""
    mesh = scene.clusters
    feats = culled._ray_features10(o, d)
    lv = None if live is None else (live > 0).to(torch.float32)
    order = None
    if reorder:
        order, lv = sort_rays(o, d, mesh, lv)
        feats = feats[order]
    feats = feats.contiguous()
    shade, sph, lights, n_point, cnst = pack_tables(scene)
    if feats.device.type == "cpu":
        outs = fused_shade_torch(feats, lv, mesh.rec, shade, sph, lights,
                                 n_point, cnst, use_shadows=use_shadows)
    else:
        outs = fused_shade_kernel(feats, lv, mesh, shade, sph, lights,
                                  n_point, cnst, use_shadows=use_shadows)
    if order is not None:
        outs = tuple(culled._unsort(x, order) for x in outs)
    direct, t, kind, index, unsh = outs
    t = torch.where(t < BIG, t, float("inf"))
    return direct, t, kind.to(torch.int64), index.to(torch.int64), unsh


# ---------------------------------------------------------------------------
# Differentiation: the kernel's value forward, the replay's gradient back
# ---------------------------------------------------------------------------


def shade_replay(o, d, p, kind, index, unsh):
    """Differentiable (direct [R, 3], t [R]) from the discrete hit
    structure (kind, index) and the unshadowed bits `unsh` [R, L], which
    gate as constants (the JAX package's `shade_replay`): the t of the
    recorded sphere (its quadratic) or triangle (`replay_triangle_t`), the
    hit point and normal, the material gathers and the clean Blinn-Phong
    sum. `p`: {leaf path of REPLAY_LEAVES: tensor}. O(rays): no scan."""
    tri_sel, sph_sel = kind == 2, kind == 1
    center = p["spheres.center"]
    si = torch.where(sph_sel, index, 0)
    c_sel = center[si]
    r_sel = p["spheres.radius"][si]
    ec = o - c_sel
    a = dot(d, d)
    b = 2.0 * dot(d, ec)
    c = dot(ec, ec) - r_sel ** 2
    t_sph = (-b - _pos_sqrt(b * b - 4.0 * a * c)) / (2.0 * a)
    v0, v1, v2 = p["triangles.v0"], p["triangles.v1"], p["triangles.v2"]
    ti = torch.clamp(torch.where(tri_sel, index, 0), max=v0.shape[0] - 1)
    t_tri = replay_triangle_t(o, d, v0, v1, v2, ti)
    t = torch.where(tri_sel, t_tri, torch.where(sph_sel, t_sph, 0.0))
    x = o + d * t[:, None]

    n_sph = normalize(x - c_sel)
    n_tri = normalize(cross(v1[ti] - v0[ti], v2[ti] - v0[ti]))
    n_tri = n_tri * torch.where(dot(n_tri, d)[:, None] > 0, -1.0, 1.0)
    normal = torch.where(tri_sel[:, None], n_tri, n_sph)

    def sel(field):
        sv = p[f"spheres.{field}"][si]
        tv = p[f"triangles.{field}"][ti]
        if sv.dim() == 1:
            sv, tv = sv[:, None], tv[:, None]
        return torch.where(tri_sel[:, None], tv, sv)

    m_amb, m_dif, m_spec, m_pow = (sel(f) for f in
                                   ("ambient", "diffuse", "specular", "power"))
    shades = (tri_sel | sph_sel)[:, None].to(o.dtype)
    view = normalize(p["camera.position"][None, :] - x)
    direct = p["ambient"][None, :] * m_amb

    def blinn_phong(ldir):
        ndotl = torch.clamp(dot(normal, ldir), min=0.0)[:, None]
        h_raw = view + ldir
        h = h_raw / torch.clamp(_pos_sqrt(dot(h_raw, h_raw)), min=1e-30
                                )[:, None]
        ndoth = torch.clamp(dot(normal, h), min=0.0)[:, None]
        sp = torch.pow(torch.clamp(ndoth, min=1e-30), m_pow) * (ndoth > 0)
        return m_dif * ndotl + m_spec * sp

    pos, pcol, pmask = (p["point_lights.position"], p["point_lights.colour"],
                        p["point_lights.mask"])
    Lp = pmask.shape[0]
    for li in range(Lp):
        l_vec = pos[li][None, :] - x
        d2 = dot(l_vec, l_vec)[:, None]
        ldir = l_vec / _pos_sqrt(torch.clamp(d2, min=1e-30))
        gate = pmask[li] * unsh[:, li:li + 1] * shades
        intensity = 1.0 / torch.clamp(d2, min=1e-30)
        direct = direct + gate * pcol[li][None, :] * intensity * blinn_phong(
            ldir)
    ddir, dcol, dmask = (p["directional_lights.direction"],
                         p["directional_lights.colour"],
                         p["directional_lights.mask"])
    for li in range(dmask.shape[0]):
        ldir = normalize(ddir[li])[None, :].expand_as(x)
        gate = dmask[li] * unsh[:, Lp + li:Lp + li + 1] * shades
        direct = direct + gate * dcol[li][None, :] * blinn_phong(ldir)
    return direct, t


def _leaf(scene, path: str):
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


class _FusedShade(torch.autograd.Function):
    """(direct, t): the kernel's values forward; backward, the gradient of
    `shade_replay` at the saved (kind, index, unshadowed)."""

    @staticmethod
    def forward(ctx, direct, t, kind, index, unsh, o, d, *leaves):
        ctx.save_for_backward(kind, index, unsh, o, d, *leaves)
        return direct.detach().clone(), t.detach().clone()

    @staticmethod
    def backward(ctx, g_direct, g_t):
        kind, index, unsh, *saved = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(bool(n))
                  for x, n in zip(saved, need)]
            direct, t = shade_replay(xs[0], xs[1],
                                     dict(zip(REPLAY_LEAVES, xs[2:])),
                                     kind, index, unsh)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad((direct, t), wrt, (g_direct, g_t),
                                             allow_unused=True))
        return (None,) * 5 + tuple(next(grads) if n else None for n in need)


def fused_shade(o, d, scene, use_shadows: bool, live=None):
    """(direct [R, 3], t [R], kind [R] int64, index [R] int64, unshadowed
    [R, L]): `fused_shade_forward`'s values, differentiable in o, d and the
    scene leaves of REPLAY_LEAVES through `shade_replay` (module
    docstring). `live` is routing data and carries no gradient."""
    with torch.no_grad():
        direct, t, kind, index, unsh = fused_shade_forward(
            o.detach(), d.detach(), scene, use_shadows=use_shadows,
            live=None if live is None else live.detach())
    leaves = [_leaf(scene, p) for p in REPLAY_LEAVES]
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (o, d, *leaves)):
        direct, t = _FusedShade.apply(direct, t, kind, index, unsh, o, d,
                                      *leaves)
    return direct, t, kind, index, unsh

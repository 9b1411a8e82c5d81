"""The wavefront glue's chains as hand-written kernels (csrc/glue.cu), one
launch each: the ray sort keys and the threefry draws (integer chains), and
the split route's hit shading before and after K4 (float chains).

On CUDA tensors, `culled._sort_rays` and `megakernel.sort_rays` take their
keys from `sort_keys_kernel`, and `sampling.uniform` its draws from
`uniform_kernel`. On CPU tensors the int64 tensor code there runs as
before: it is the plain version of each kernel and the tests' oracle
(`culled.footprint_keys_torch`, `megakernel.spatial_keys_torch`,
`sampling.uniform_torch`), and each kernel gives its bits exactly (the
per-ray math is csrc/glue_math.cuh, which the CPU tests build for the host).
The stable `torch.sort` of the keys and the gather of `live` stay with the
callers.

The hit shading (`shade_hit_kernel`, G3; `shade_direct_kernel`, G4) serves
models/integrator.py `_shade_hit` on the split route, where
`integrator._shade_kernels` takes it (CUDA tensors, no gradient, no live
fog, triangle shadows through K4). G3 turns the scans' answers into the
hit record and the material and writes K4's shadow rays; G4 turns K4's
answers into the direct term. The tensor code of ops/geometry.py and
ops/shading.py is their plain version and serves the CPU, autograd and
live fog; the per-ray math is csrc/shade_math.cuh, which the CPU tests
build for the host.

Each wrapper launches on the current stream, so a chunk's CUDA graph
(models/graphs.py) captures it; `uniform_kernel` reads a tensor seed from
the device when the kernel runs, so a replay with a new seed in the
graph's static seed draws the new stream. Launches are counted in
LAUNCHES.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from skele_raytracer_tpu_torch.config import CLEAN_T_EPS, SHADOW_ORIGIN_EPS
from skele_raytracer_tpu_torch.ops.cuda._build import check_outputs
from skele_raytracer_tpu_torch.ops.cuda.intersect import BIG
from skele_raytracer_tpu_torch.utils import profiling

KEY_FOOTPRINT, KEY_SPATIAL = 0, 1  # csrc/glue_math.cuh key modes
_MASK = 0xFFFFFFFF

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"sort_keys": 0, "uniform": 0, "shade_hit": 0, "shade_direct": 0}
profiling.COUNTERS["launches"]["glue"] = LAUNCHES

_lib = None


def bind(lib):
    """Declares the four launchers of a loaded library."""
    lib.glue_sort_keys.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 6)
    lib.glue_uniform.argtypes = (
        [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_uint] * 3 + [ctypes.c_void_p] * 2)
    for f in (lib.glue_shade_hit, lib.glue_shade_direct):
        f.argtypes = [ctypes.POINTER(ShadeArgs), ctypes.c_void_p]
    for f in (lib.glue_sort_keys, lib.glue_uniform, lib.glue_shade_hit,
              lib.glue_shade_direct):
        f.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (if needed) and load the CUDA kernel library."""
    global _lib
    if _lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        _lib = bind(load_cuda("glue"))
    return _lib


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def sort_keys_kernel(o, d, table, live=None, *, mode: int,
                     allow_negative: bool = False):
    """[R] int64 sort keys of rays o, d [R, 3] (float32, any strides) on
    the card: KEY_FOOTPRINT, `culled.footprint_keys_torch`'s, or
    KEY_SPATIAL, `megakernel.spatial_keys_torch`'s, over `table`
    (`ClusteredMesh.sort_table`: the supercluster boxes, then the mesh
    box); `live` [R] float32 or None. Counted in LAUNCHES["sort_keys"]."""
    dev = o.device
    R = o.shape[0]
    n_sc = (table.shape[0] - 6) // 6
    if dev.type != "cuda":
        raise ValueError(f"sort_keys kernel: CUDA tensors, got {dev}")
    if live is not None:
        live = live.contiguous()
    for x, shape in ((o, (R, 3)), (d, (R, 3)), (table, (6 * n_sc + 6,)),
                     (live, (R,))):
        if x is None:
            continue
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"sort_keys kernel: float32 operands on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"sort_keys kernel: operand {shape}, got "
                             f"{tuple(x.shape)}")
    if not table.is_contiguous():
        raise ValueError("sort_keys kernel: a contiguous table")
    if R >= 2**31:
        raise ValueError("sort_keys kernel: fewer than 2^31 rays")
    keys = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return keys
    lib = build_kernel()
    with torch.cuda.device(dev):
        err = lib.glue_sort_keys(
            R, mode, n_sc, int(allow_negative), *o.stride(), *d.stride(),
            o.data_ptr(), d.data_ptr(),
            None if live is None else live.data_ptr(), table.data_ptr(),
            keys.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"sort_keys kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["sort_keys"] += 1
    check_outputs("sort_keys", keys)
    return keys


def uniform_kernel(seed, ray_id, bounce, purpose, shape=()):
    """`sampling.uniform` on the card in one launch: [R, *shape] float32
    draws for ray_id [R] (int64 or int32). `seed`: an int, or a 0-d
    integer tensor, moved to ray_id's device as int64 where it is not
    there (the twin's `_u32` does the same) and read there when the kernel
    runs, never copied to the host. Counted in LAUNCHES["uniform"]."""
    dev = ray_id.device
    if dev.type != "cuda":
        raise ValueError(f"uniform kernel: CUDA tensors, got {dev}")
    if ray_id.dim() != 1 or ray_id.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"uniform kernel: ray_id [R] int64 or int32, got "
                         f"{ray_id.dtype} {tuple(ray_id.shape)}")
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    R = ray_id.shape[0]
    out = torch.empty((R, n), dtype=torch.float32, device=dev)
    seed_dev, seed_int = None, 0
    if isinstance(seed, torch.Tensor):
        seed_dev = seed.to(device=dev, dtype=torch.int64).reshape(())
    else:
        seed_int = int(seed) & _MASK
    if R == 0 or n == 0:
        return out.reshape((R,) + tuple(shape))
    ids = ray_id.contiguous()
    lib = build_kernel()
    with torch.cuda.device(dev):
        err = lib.glue_uniform(
            R, n, int(ids.dtype == torch.int64), ids.data_ptr(),
            None if seed_dev is None else seed_dev.data_ptr(), seed_int,
            int(bounce) & _MASK, int(purpose) & _MASK, out.data_ptr(),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"uniform kernel launch failed: CUDA error {err}")
    LAUNCHES["uniform"] += 1
    check_outputs("uniform", out)
    return out.reshape((R,) + tuple(shape))


# ---------------------------------------------------------------------------
# The split route's hit shading: G3 before K4, G4 after it
# ---------------------------------------------------------------------------

# csrc/shade_math.cuh ShadeArgs::flags
(HAS_SPHERES, HAS_TRIANGLES, TRIANGLES_BLACK, SCALAR_EPS, POINT_BLOCK,
 DIR_BLOCK, SHADOWS, BOUNDED, K4_SHADOWS, HAS_LIVE) = (
    1 << k for k in range(10))

_P = ctypes.c_void_p


class ShadeArgs(ctypes.Structure):
    """csrc/shade_math.cuh `ShadeArgs`: the operands of G3 and G4."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in ("R", "S", "T", "N", "Lp", "Ld", "so0",
                                       "so1", "sd0", "sd1")]
        + [("flags", ctypes.c_int32), ("pad", ctypes.c_int32)]
        + [(n, ctypes.c_float) for n in ("t_eps", "shadow_eps", "t_clip",
                                         "big")]
        + [(n, _P) for n in ("o", "d", "live", "sph_t", "sph_index",
                             "sph_hit", "tri_t", "tri_index", "tri_hit",
                             "center", "radius", "smask")]
        + [("s_mat", _P * 6), ("t_mat", _P * 6)]
        + [(n, _P) for n in ("tri_normals", "p_pos", "p_col", "p_mask",
                             "d_dir", "d_col", "d_mask", "ambient", "camera",
                             "kind", "index", "t", "point", "normal", "mat",
                             "shades", "miss", "feats_p", "bound_p",
                             "feats_d", "bound_d", "k4_live", "occ_p",
                             "occ_d", "direct")])


class HitShading(NamedTuple):
    """G3's outputs: the hit record (`geometry.Hits`' fields), the material
    [R, 14] (`shading._pack_material`'s columns), shades and miss [R]
    bool, and K4's shadow rays toward the point and the directional lights
    (feature rows [L R, 10] and bounds [L R], light-major, or None where
    K4 does not run for that kind) with their live mask [max(Lp, Ld) R]
    (1.0 where the ray hit and is live). `args` and `keep` are G4's
    operands and the tensors they point at."""

    kind: torch.Tensor
    index: torch.Tensor
    t: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    mat: torch.Tensor
    shades: torch.Tensor
    miss: torch.Tensor
    feats_p: Optional[torch.Tensor]
    bound_p: Optional[torch.Tensor]
    feats_d: Optional[torch.Tensor]
    bound_d: Optional[torch.Tensor]
    k4_live: Optional[torch.Tensor]
    args: ShadeArgs
    keep: list


def _run_shade(name: str, args: ShadeArgs, device) -> None:
    """Launches `glue_<name>` on the current stream of `device`."""
    if device.type != "cuda":
        raise ValueError(f"{name} kernel: CUDA tensors, got {device}")
    lib = build_kernel()
    with torch.cuda.device(device):
        err = getattr(lib, "glue_" + name)(ctypes.byref(args),
                                           _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _flags(scene, cfg, k4: bool, has_live: bool) -> int:
    q = cfg.quirks
    bits = [(scene.has_spheres, HAS_SPHERES),
            (scene.has_triangles, HAS_TRIANGLES),
            (q.triangles_shade_black, TRIANGLES_BLACK),
            (q.scalar_epsilon_offset, SCALAR_EPS),
            (scene.has_point_lights and not scene.has_fog, POINT_BLOCK),
            (scene.has_directional, DIR_BLOCK), (cfg.use_shadows, SHADOWS),
            (not q.near_clip_t_le_1, BOUNDED), (k4, K4_SHADOWS),
            (has_live, HAS_LIVE)]
    return sum(bit for on, bit in bits if on)


def shade_hit_kernel(o, d, live, sph, tri, scene, cfg, *,
                     k4: bool) -> HitShading:
    """G3 on the card: `integrator._shade_hit`'s split route from the scans
    to K4. o, d [R, 3] float32 (any strides); live [R] float32 or None (a
    bounce wave); sph (t, index, hit) of `geometry.nearest_sphere`, None
    without spheres; tri (t, index, hit) of the triangle scan, None without
    triangles; `k4`: triangles occlude through K4 (the shadow rays are
    written). A scene with live fog is not served (`_fog_term`). Counted in
    LAUNCHES["shade_hit"]."""
    dev = o.device
    R = o.shape[0]
    q = cfg.quirks
    if scene.has_fog and not scene.fog_zeroed:
        raise ValueError("shade_hit kernel: live fog is shaded by the "
                         "tensor code")
    keep = [o, d]

    def ptr(x, dtype=torch.float32, shape=None):
        if x is None:
            return None
        x = _operand(x, dtype, dev)
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"shade_hit kernel: operand {shape}, got "
                             f"{tuple(x.shape)}")
        keep.append(x)
        return x.data_ptr()

    for x in (o, d):
        if x.device != dev or x.dtype != torch.float32 or x.shape != (R, 3):
            raise ValueError(f"shade_hit kernel: o, d [{R}, 3] float32 on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    sp, tr = scene.spheres, scene.triangles
    pl, dl = scene.point_lights, scene.directional_lights
    Lp, Ld = pl.mask.shape[0], dl.mask.shape[0]
    flags = _flags(scene, cfg, k4, live is not None)
    a = ShadeArgs(R=R, S=sp.mask.shape[0], T=tr.mask.shape[0],
                  N=0 if scene.tri_normals is None
                  else scene.tri_normals.shape[0],
                  Lp=Lp, Ld=Ld, flags=flags, t_eps=CLEAN_T_EPS,
                  shadow_eps=SHADOW_ORIGIN_EPS,
                  t_clip=1.0 if q.near_clip_t_le_1 else CLEAN_T_EPS,
                  big=BIG)
    a.so0, a.so1 = o.stride()
    a.sd0, a.sd1 = d.stride()
    a.o, a.d = o.data_ptr(), d.data_ptr()
    a.live = ptr(live, shape=(R,))
    if sph is not None:
        a.sph_t = ptr(sph[0], shape=(R,))
        a.sph_index = ptr(sph[1], torch.int64, (R,))
        a.sph_hit = ptr(sph[2], torch.bool, (R,))
    if tri is not None:
        a.tri_t = ptr(tri[0], shape=(R,))
        a.tri_index = ptr(tri[1], torch.int64, (R,))
        a.tri_hit = ptr(tri[2], torch.bool, (R,))
    if (sph is None) == bool(flags & HAS_SPHERES) or (
            (tri is None) == bool(flags & HAS_TRIANGLES)):
        raise ValueError("shade_hit kernel: sphere and triangle hits "
                         "exactly where the scene has them")
    a.center, a.radius, a.smask = ptr(sp.center), ptr(sp.radius), ptr(sp.mask)
    for k, name in enumerate(("ambient", "diffuse", "specular",
                              "transmissive", "power", "ior")):
        a.s_mat[k] = ptr(getattr(sp, name))
        a.t_mat[k] = ptr(getattr(tr, name))
    a.tri_normals = ptr(scene.tri_normals)
    a.p_pos, a.p_col, a.p_mask = ptr(pl.position), ptr(pl.colour), ptr(
        pl.mask)
    a.d_dir, a.d_col, a.d_mask = ptr(dl.direction), ptr(dl.colour), ptr(
        dl.mask)
    a.ambient, a.camera = ptr(scene.ambient), ptr(scene.camera.position)

    new = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=dev)
    out = dict(kind=new(R, dtype=torch.int64), index=new(R, dtype=torch.int64),
               t=new(R), point=new(R, 3), normal=new(R, 3), mat=new(R, 14),
               shades=new(R, dtype=torch.bool), miss=new(R, dtype=torch.bool),
               feats_p=None, bound_p=None, feats_d=None, bound_d=None,
               k4_live=None)
    if k4:
        if flags & POINT_BLOCK:
            out.update(feats_p=new(Lp * R, 10), bound_p=new(Lp * R))
        if flags & DIR_BLOCK:
            out.update(feats_d=new(Ld * R, 10), bound_d=new(Ld * R))
        out["k4_live"] = new(max(Lp, Ld) * R)
    for name, x in out.items():
        setattr(a, name, None if x is None else x.data_ptr())
    if R > 0:
        _run_shade("shade_hit", a, dev)
        LAUNCHES["shade_hit"] += 1
        check_outputs("shade_hit", *(x for x in out.values()
                                     if x is not None))
    return HitShading(**out, args=a, keep=keep)


def shade_direct_kernel(hs: HitShading, occ_p=None, occ_d=None):
    """G4 on the card: the direct term [R, 3] (`shading.
    direct_illumination`) at G3's hits `hs`, with K4's answers toward the
    point and the directional lights ([L R] bool, light-major; None where
    K4 did not run). Counted in LAUNCHES["shade_direct"]."""
    a = ShadeArgs.from_buffer_copy(hs.args)
    dev = hs.point.device
    R = hs.point.shape[0]
    for name, occ, L in (("occ_p", occ_p, a.Lp), ("occ_d", occ_d, a.Ld)):
        if occ is not None:
            occ = _operand(occ, torch.bool, dev)
            if tuple(occ.shape) != (L * R,):
                raise ValueError(f"shade_direct kernel: {name} [{L * R}], "
                                 f"got {tuple(occ.shape)}")
        setattr(a, name, None if occ is None else occ.data_ptr())
    direct = torch.empty((R, 3), dtype=torch.float32, device=dev)
    a.direct = direct.data_ptr()
    if R > 0:
        _run_shade("shade_direct", a, dev)
        LAUNCHES["shade_direct"] += 1
        check_outputs("shade_direct", direct)
    return direct


def _operand(x, dtype, dev):
    """x as a contiguous `dtype` tensor on `dev`, or raises."""
    if x.device != dev or x.dtype != dtype:
        raise ValueError(f"shade kernels: {dtype} operands on {dev}, got "
                         f"{x.dtype} on {x.device}")
    return x.contiguous()

"""Brute-force nearest-triangle kernel K5 and nearest-sphere kernel K6:
host side, plain PyTorch versions and the CUDA kernels' wrappers.

The counterpart of the JAX package's `ops/pallas/intersect.py`
(`triangle_nearest`, kernel `_triangle_kernel`). The path sends meshes of
64 to 1,024 triangles here (at most 4 clusters, ops/geometry.py); larger
meshes take the culled kernel (ops/cuda/culled.py).

Per ray the features [d, o x d, o] (`ray_features`), per triangle a
20-float record (`pack_triangles`): the constants of the TPU kernel's
single-matmul Moller-Trumbore test (A, B, -e2, -C, -e1, D, -kof, index;
csrc/mesh_math.cuh). `triangle_nearest_torch` is the plain version: the
same per-(ray, triangle) formula as csrc/mesh_math.cuh `planes` +
`brute_t`, summed in the same order with elementwise ops, then the first
minimum (the earliest triangle wins a tie). `triangle_nearest` is the
wrapper: CPU tensors run the plain version, CUDA tensors launch
csrc/intersect.cu or raise.

K6 (`sphere_nearest`, the counterpart of the JAX package's
`sphere_nearest` and `_sphere_kernel`) scans spheres with the expanded
quadratic of csrc/sphere_math.cuh, the same function the fused kernel K7
scans spheres with (ops/cuda/megakernel.py). On CUDA tensors one call is
one launch: the kernel builds the sphere rows from the contract's
operands and writes t, the int64 index and hit itself. As in the JAX
package no render path launches it: `geometry.intersect` keeps its plain
sphere scan. `sphere_nearest_torch` is its plain version, term for term in
the header's order, on the rows `sphere_rows` builds.
"""

from __future__ import annotations

import ctypes

import torch

from skele_raytracer_tpu_torch.config import CLEAN_T_EPS, TRIANGLE_DET_EPS, Quirks
from skele_raytracer_tpu_torch.ops.cuda._build import check_outputs
from skele_raytracer_tpu_torch.ops.geometry import cross, dot
from skele_raytracer_tpu_torch.utils import profiling

BIG = 3.0e38  # stand-in for +inf (a miss), as float32
REC = 20

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"triangle_nearest": 0, "sphere_nearest": 0}
profiling.COUNTERS["launches"]["intersect"] = LAUNCHES
SPH = 5  # floats per sphere row (csrc/sphere_math.cuh)

# Lanes per ray K5 is built for (csrc/intersect.cu triangle_nearest_lanes);
# its launcher takes `triangle_nearest_default_lanes()` of them.
LANES = (1, 4, 8, 16, 32)
# Lanes per ray of K6's lane sweep (`sphere_nearest_lanes`, for measurement
# and tests); K6 itself runs one lane per ray.
K6_SWEEP_LANES = (2, 4, 8)

# [rays x triangles] elements the plain versions evaluate at once.
PLAIN_BLOCK = {"cpu": 1 << 21, "cuda": 1 << 24}


def ray_features(o, d):
    """[R, 9] feature rows [d, o x d, o]."""
    return torch.cat([d, cross(o, d), o], dim=1)


def pack_triangles(v0, v1, v2, mask):
    """[T, 20] triangle records (csrc/mesh_math.cuh layout) from the
    scene's triangle table: the nonzeros of the JAX package's
    pack_triangles K [9, 4, T] and -k, the mask folded in (masked rows are
    zero), and the index."""
    e1 = v1 - v0
    e2 = v2 - v0
    C = cross(v0, e1)
    kof = (e2 * C).sum(dim=1, keepdim=True)
    rec = torch.cat([cross(e2, e1), cross(e2, v0), -e2, -C, -e1,
                     cross(e1, e2), -kof], dim=1) * (mask > 0)[:, None]
    idx = torch.arange(v0.shape[0], dtype=torch.float32, device=v0.device)
    return torch.cat([rec, idx[:, None]], dim=1).contiguous()


def planes_torch(f, rec, sign: float, paired: bool = False):
    """(det, u_num, v_num, t_num), each [R, T], of feature rows f [R, >=9]
    against records [T, 20]: csrc/mesh_math.cuh `planes`, term for term.
    paired: rec is [R, 20], one record per ray, and the planes are
    [R, 1]."""
    c = lambda k: f[:, k:k + 1]
    r = (lambda k: rec[:, k:k + 1]) if paired else (lambda k: rec[None, :, k])
    det = c(0) * r(0) + c(1) * r(1) + c(2) * r(2)
    u = sign * (c(0) * r(3) + c(1) * r(4) + c(2) * r(5) + c(3) * r(6)
                + c(4) * r(7) + c(5) * r(8))
    v = (c(0) * r(9) + c(1) * r(10) + c(2) * r(11) + c(3) * r(12)
         + c(4) * r(13) + c(5) * r(14))
    t = c(6) * r(15) + c(7) * r(16) + c(8) * r(17) + r(18)
    return det, u, v, t


def _brute_t(det, u_num, v_num, t_num, clip: bool):
    """csrc/mesh_math.cuh `brute_t` on [R, T] planes: (t or BIG, u, v)."""
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    u, v, t = u_num * inv, v_num * inv, t_num * inv
    valid = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    if clip:
        valid = valid & (t > CLEAN_T_EPS)
    return torch.where(valid, t, BIG), u, v


def triangle_nearest_torch(feats, rec, *, sign: float, clip: bool):
    """Plain version of the kernel: (t [R] (BIG = miss), index [R] int32
    (first minimum; 0 on a miss), u [R], v [R]) for features [R, 9] and
    records [T, 20]."""
    R, T = feats.shape[0], rec.shape[0]
    step = max(1, PLAIN_BLOCK[feats.device.type] // max(T, 1))
    outs = []
    for r0 in range(0, R, step):
        f = feats[r0:r0 + step]
        t_all, _, _ = _brute_t(*planes_torch(f, rec, sign), clip)
        idx = torch.argmin(t_all, dim=1)
        t = torch.gather(t_all, 1, idx[:, None])[:, 0]
        _, u, v = _brute_t(*planes_torch(f, rec[idx], sign, paired=True),
                           clip)
        outs.append((t, idx, u[:, 0], v[:, 0]))
    t, idx, u, v = (torch.cat(x) for x in zip(*outs))
    return t, idx.to(torch.int32), u, v


def sphere_rows(center, radius, mask):
    """[S, 5] sphere rows (csrc/sphere_math.cuh): center, |c|^2 - r^2 (as
    the JAX kernel's aux row), mask."""
    cc = dot(center, center) - radius * radius
    return torch.cat([center, cc[:, None], mask[:, None]], dim=1).contiguous()


def sqrt_rn(x):
    """Correctly rounded float32 square root, as CUDA's sqrtf (without
    fast math) and C's sqrtf: through float64. PyTorch's float32 sqrt on
    the CPU may be an ulp off."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def sphere_disc_torch(o, d, rows):
    """(a [R, 1], b [R, S], disc [R, S]) of rays o, d [R, 3] against sphere
    rows [S, >= 4]: csrc/sphere_math.cuh `sphere_disc`, term for term."""
    c = lambda k: rows[None, :, k]
    a = dot(d, d)[:, None]
    d_o = dot(d, o)[:, None]
    o_o = dot(o, o)[:, None]
    d_c = d[:, 0:1] * c(0) + d[:, 1:2] * c(1) + d[:, 2:3] * c(2)
    o_c = o[:, 0:1] * c(0) + o[:, 1:2] * c(1) + o[:, 2:3] * c(2)
    b = 2.0 * (d_o - d_c)
    cq = o_o - 2.0 * o_c + c(3)
    return a, b, b * b - 4.0 * a * cq


def sphere_t_all_torch(o, d, rows, t_clip: float):
    """[R, S] t of rays o, d [R, 3] against sphere rows [S, >= 5] (BIG
    where not hit): csrc/sphere_math.cuh `sphere_t`, term for term."""
    a, b, disc = sphere_disc_torch(o, d, rows)
    pos = disc > 0
    sq = sqrt_rn(torch.where(pos, disc, 1.0)) * pos
    t2 = (-b - sq) / (2.0 * a)
    valid = (disc >= 0) & (t2 >= 0) & (t2 > t_clip) & (rows[None, :, 4] > 0)
    return torch.where(valid, t2, BIG)


def first_min(t_all):
    """(t [R], index [R] int32): the smallest value per row and the
    earliest column among ties (csrc/sphere_math.cuh `nearest`)."""
    t = t_all.amin(dim=1)
    cols = torch.arange(t_all.shape[1], device=t_all.device)
    idx = torch.where(t_all == t[:, None], cols, t_all.shape[1]).amin(dim=1)
    return t, idx.to(torch.int32)


def sphere_nearest_torch(o, d, rows, t_clip: float):
    """Plain version of K6: (t [R] (BIG = miss), index [R] int32, the
    first minimum; 0 when every row misses)."""
    step = max(1, PLAIN_BLOCK[o.device.type] // max(rows.shape[0], 1))
    outs = [first_min(sphere_t_all_torch(o[i:i + step], d[i:i + step], rows,
                                         t_clip))
            for i in range(0, o.shape[0], step)]
    return tuple(torch.cat(x) for x in zip(*outs))


_lib = None


def bind(lib):
    """Declares `triangle_nearest` and K6's entry of a loaded library:
    `sphere_nearest_hits` (the contract's operands and outputs) or, in a
    library built before K6 took them, `sphere_nearest` (rows [S, 5] in; t
    and an int32 index out). The C signature of `triangle_nearest` has not
    changed since the port's first K5, so a library built from an earlier
    tree binds too."""
    lib.triangle_nearest.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 7)
    lib.triangle_nearest.restype = ctypes.c_int
    if hasattr(lib, "sphere_nearest_hits"):
        lib.sphere_nearest_hits.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 9)
        lib.sphere_nearest_hits.restype = ctypes.c_int
    else:
        lib.sphere_nearest.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 6)
        lib.sphere_nearest.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (if needed) and load the CUDA kernel library."""
    global _lib
    if _lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        lib = bind(load_cuda("intersect"))
        lib.triangle_nearest_lanes.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_float] * 2
            + [ctypes.c_void_p] * 7)
        lib.triangle_nearest_lanes.restype = ctypes.c_int
        lib.triangle_nearest_default_lanes.restype = ctypes.c_int
        _lib = lib
    return _lib


_sweep_lib = None


def build_sweep_kernel():
    """Build (if needed) and load K6's lane sweep, csrc/intersect.cu built
    with INTERSECT_LANE_SWEEP: `sphere_nearest_hits_lanes` runs K6 at any
    of K6_SWEEP_LANES lanes per ray, for measurements and tests."""
    global _sweep_lib
    if _sweep_lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        lib = load_cuda("intersect_sweep")
        lib.sphere_nearest_hits_lanes.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 9)
        lib.sphere_nearest_hits_lanes.restype = ctypes.c_int
        _sweep_lib = lib
    return _sweep_lib


def launcher_lanes():
    """Lanes per ray K5's launcher takes."""
    return build_kernel().triangle_nearest_default_lanes()


def triangle_nearest_kernel(feats, rec, *, sign: float, clip: bool,
                            lanes=None):
    """The kernel on CUDA tensors (same outputs as the plain version);
    counted in LAUNCHES["triangle_nearest"]. `lanes` (one of LANES) forces
    the lanes per ray, for measurements and tests only; None: the
    launcher's choice."""
    dev = feats.device
    if dev.type != "cuda" or rec.device != dev:
        raise ValueError(f"triangle_nearest kernel: CUDA tensors on one "
                         f"device, got {dev} and {rec.device}")
    if feats.dtype != torch.float32 or rec.dtype != torch.float32:
        raise ValueError("triangle_nearest kernel: float32 operands")
    if feats.dim() != 2 or feats.shape[1] != 9 or rec.dim() != 2 or (
            rec.shape[1] != REC):
        raise ValueError(f"triangle_nearest kernel: feats [R, 9] and rec "
                         f"[T, {REC}], got {tuple(feats.shape)}, "
                         f"{tuple(rec.shape)}")
    n, T = feats.shape[0], rec.shape[0]
    if n >= 2**31 or T >= 2**24:
        raise ValueError("triangle_nearest kernel: too many rays or triangles")
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"triangle_nearest kernel: lanes {lanes} not in "
                         f"{LANES}")
    lib = build_kernel()
    feats, rec = feats.contiguous(), rec.contiguous()
    if rec.data_ptr() % 16:  # the bulk copies read 16-byte-aligned tiles
        rec = rec.clone()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr() for x in (feats, rec, t, idx, u, v)]
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if lanes is None:
            err = lib.triangle_nearest(n, T, int(clip), sign, CLEAN_T_EPS,
                                       *ptrs, stream)
        else:
            err = lib.triangle_nearest_lanes(lanes, n, T, int(clip), sign,
                                             CLEAN_T_EPS, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"triangle_nearest kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["triangle_nearest"] += 1
    check_outputs("triangle_nearest", t, idx, u, v)
    return t, idx, u, v


def _sphere_launch(launch, o, d, center, radius, mask):
    """Checks K6's operands, allocates its outputs and calls
    `launch(n, S, *pointers, stream)` (a C entry with
    sphere_nearest_hits's operands after its first ones); counted in
    LAUNCHES["sphere_nearest"]."""
    dev = o.device
    ops = (o, d, center, radius, mask)
    if dev.type != "cuda" or any(x.device != dev for x in ops):
        raise ValueError(f"sphere_nearest kernel: CUDA tensors on one device, "
                         f"got {', '.join(str(x.device) for x in ops)}")
    if any(x.dtype != torch.float32 for x in ops):
        raise ValueError("sphere_nearest kernel: float32 operands")
    S = center.shape[0] if center.dim() == 2 else -1
    if (o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape
            or center.shape != (S, 3) or radius.shape != (S,)
            or mask.shape != (S,)):
        raise ValueError(f"sphere_nearest kernel: o, d [R, 3], center "
                         f"[S, 3], radius and mask [S], got "
                         + ", ".join(str(tuple(x.shape)) for x in ops))
    n = o.shape[0]
    if n >= 2**31 or S >= 2**24:
        raise ValueError("sphere_nearest kernel: too many rays or spheres")
    ops = [x.contiguous() for x in ops]  # no copy where they already are
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    ptrs = [x.data_ptr() for x in (*ops, t, idx, hit)]
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = launch(n, S, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"sphere_nearest kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["sphere_nearest"] += 1
    check_outputs("sphere_nearest", t, idx, hit)
    return t, idx, hit


def sphere_nearest_kernel(o, d, center, radius, mask, t_clip: float):
    """K6 on CUDA tensors: `sphere_nearest`'s outputs (t, +inf on a miss;
    index int64; hit) from one launch, counted in
    LAUNCHES["sphere_nearest"]."""
    lib = build_kernel()
    return _sphere_launch(
        lambda n, S, *ptrs: lib.sphere_nearest_hits(n, S, t_clip, *ptrs),
        o, d, center, radius, mask)


def sphere_nearest_lanes(o, d, center, radius, mask, t_clip: float,
                         lanes: int):
    """K6's lane sweep: `sphere_nearest_kernel`'s outputs with `lanes` (one
    of K6_SWEEP_LANES) lanes per ray, for measurements and tests only."""
    if lanes not in K6_SWEEP_LANES:
        raise ValueError(f"sphere_nearest kernel: lanes {lanes} not in "
                         f"{K6_SWEEP_LANES}")
    lib = build_sweep_kernel()
    return _sphere_launch(
        lambda n, S, *ptrs: lib.sphere_nearest_hits_lanes(lanes, n, S, t_clip,
                                                          *ptrs),
        o, d, center, radius, mask)


def sphere_nearest_plain(o, d, center, radius, mask, t_clip: float):
    """The plain version of `sphere_nearest_kernel`: the rows, the plain
    scan and the contract's outputs, on any device."""
    t, idx = sphere_nearest_torch(o, d, sphere_rows(center, radius, mask),
                                  t_clip)
    hit = t < BIG
    return torch.where(hit, t, float("inf")), idx.to(torch.int64), hit


def sphere_nearest(o, d, center, radius, mask, *, quirks: Quirks):
    """(t [R], index [R] int64, hit [R] bool): nearest sphere per ray, the
    JAX package's `sphere_nearest` contract (t = inf on a miss; the index
    is the first minimum, 0 when no sphere is hit). t_clip is 1.0 under
    near_clip_t_le_1 and CLEAN_T_EPS otherwise. CPU tensors run the plain
    version, CUDA tensors the kernel K6 (one launch)."""
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    if o.device.type == "cpu":
        return sphere_nearest_plain(o, d, center, radius, mask, t_clip)
    return sphere_nearest_kernel(o, d, center, radius, mask, t_clip)


def triangle_nearest(o, d, v0, v1, v2, mask, *, quirks: Quirks):
    """(t, index, hit, u, v): nearest triangle per ray, reference
    semantics (geometry.nearest_triangle): parity accepts negative t and
    the mirrored u; clean is standard MT with t > CLEAN_T_EPS. t is inf on
    a miss; the index is clamped to T - 1. CPU tensors run the plain
    version, CUDA tensors the kernel."""
    sign = 1.0 if quirks.reference_triangle_test else -1.0
    clip = not quirks.reference_triangle_test
    feats = ray_features(o, d)
    rec = pack_triangles(v0, v1, v2, mask)
    if feats.device.type == "cpu":
        t, idx, u, v = triangle_nearest_torch(feats, rec, sign=sign, clip=clip)
    else:
        t, idx, u, v = triangle_nearest_kernel(feats, rec, sign=sign, clip=clip)
    hit = t < BIG
    T = v0.shape[0]
    return (torch.where(hit, t, float("inf")),
            torch.clamp(idx.to(torch.int64), max=T - 1), hit, u, v)

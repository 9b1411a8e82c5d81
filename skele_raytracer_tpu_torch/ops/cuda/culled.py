"""Cluster-culled triangle kernels K3 (nearest hit) and K4 (any hit, shadow
rays): host side, plain PyTorch versions and the CUDA kernels' wrappers.

The counterpart of the JAX package's `ops/pallas/culled.py`
(`triangle_nearest_culled` / `_culled_kernel` and `triangle_occluded` /
`_occluded_kernel`). The path sends every mesh of more than 4 Morton
clusters here (ops/geometry.py, ops/shading.py).

The top-level functions keep the JAX package's contract: rays are sorted
by a footprint key (`_footprint_sort_keys`: which of 16 superclusters the
ray enters, then direction and origin) so that a tile of the kernel
enters few clusters, the kernel runs on the sorted batch, and the
results are scattered back. Dead rays (`live == 0`) return a miss; a live
ray's answer depends on neither the order, the tiling, the clustering
(coarse or fine) nor `live`.

The plain versions (`culled_nearest_torch`, `culled_occluded_torch`) are
the same contract done brute force: every clustered triangle record, rays
in chunks, the formula of csrc/mesh_math.cuh summed in the same order
(`intersect.planes_torch`), the same tie-break. The wrappers run them on
CPU tensors and launch csrc/culled.cu on CUDA tensors, or raise.

K3, K4 (and K7, ops/cuda/megakernel.py) run G lanes per ray in blocks of
THREADS threads (csrc/cluster_walk.cuh); `launch_shape` is the launch
arithmetic the C launchers use: G from the wave's size (`lanes_for`; K4:
one count at every size, `occluded_lanes`), rays per block, blocks, and
dynamic shared memory (a two-stage ring of cluster records, the box table
and the shortlist).

Not ported: `pack_cluster_blocks` (the triangle records of
ops/accel.py replace its folded blocks), `_batched_launch`/`MAX_TILES`
(they bound the TPU's scalar memory; a CUDA block builds its own
shortlist) and the clean mode's bf16x3 product (`mt_passes=3`, a TPU
matrix-unit economy): both modes compute in full FP32.
"""

from __future__ import annotations

import ctypes

import torch

from skele_raytracer_tpu_torch.config import CLEAN_T_EPS, TRIANGLE_DET_EPS, Quirks
from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import glue
from skele_raytracer_tpu_torch.ops.cuda._build import check_outputs
from skele_raytracer_tpu_torch.ops.cuda.intersect import (
    BIG,
    PLAIN_BLOCK,
    REC,
    planes_torch,
)
from skele_raytracer_tpu_torch.ops.geometry import cross
from skele_raytracer_tpu_torch.utils import profiling

BIG_I = 1 << 30  # "no triangle" index of a miss, before the clamp
_MASK = 0xFFFFFFFF
_DEAD = _MASK  # sort key of a dead ray: sorts to the tail

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"culled_nearest": 0, "culled_occluded": 0}
profiling.COUNTERS["launches"]["culled"] = LAUNCHES

THREADS = 256  # threads per block of K3 and K7 (csrc/cluster_walk.cuh)
# lanes per ray K3 and K7 are built for; K4's launcher takes one count
# (`occluded_lanes`)
LANES = (8, 16, 32)
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90


def lanes_for(n: int) -> int:
    """Lanes per ray the C launchers pick for an n-ray wave
    (csrc/cluster_walk.cuh `lanes_for`)."""
    return 32 if n <= 16384 else 16


def launch_shape(n: int, C: int, cs: int, lanes: int | None = None,
                 extra_floats: int = 0):
    """(lanes, rays per block, blocks, dynamic shared-memory bytes) of a K3
    launch on n rays over C clusters of cs triangles (K7 adds its tables'
    `extra_floats`), as csrc/cluster_walk.cuh computes them. Raises
    ValueError for lanes the kernels are not built for and for a block
    that would not fit in shared memory."""
    g = lanes_for(n) if lanes is None else lanes
    if g not in LANES:
        raise ValueError(f"lanes per ray: one of {LANES}, got {g}")
    rays = THREADS // g
    smem = 4 * (2 * cs * REC + extra_floats + 6 * C + C + 1) + 4 * 3 * C
    if smem > SMEM_LIMIT:
        raise ValueError(f"{C} clusters of {cs} triangles need {smem} bytes "
                         f"of shared memory per block, more than "
                         f"{SMEM_LIMIT}")
    return g, rays, -(-n // rays), smem


def _ray_features10(o, d):
    """[R, 10] feature rows [d, o x d, o, 1] (csrc/mesh_math.cuh)."""
    one = torch.ones((o.shape[0], 1), dtype=o.dtype, device=o.device)
    return torch.cat([d, cross(o, d), o, one], dim=1)


# ---------------------------------------------------------------------------
# Ray sort keys: uint32 values carried in int64 tensors (torch has no uint32
# shifts on the CPU), masked to 32 bits after each shift.
# ---------------------------------------------------------------------------


def _spatial_sort_keys(o, d, lo, hi):
    """Sort key per ray: a 7-bit direction bucket (octant and two 2-bit
    axis ratios) in the high bits, a 24-bit Morton code of the origin
    (quantized to the mesh box) below. Bitwise the JAX package's."""
    span = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((o - lo) / span * 255.0, 0.0, 255.0).to(torch.int64)

    def spread8(v):  # 8 bits -> every third bit of 24
        v = (v | (v << 8)) & 0x00F00F
        v = (v | (v << 4)) & 0x0C30C3
        v = (v | (v << 2)) & 0x249249
        return v

    morton = (spread8(q[:, 0]) << 2) | (spread8(q[:, 1]) << 1) | spread8(q[:, 2])
    octant = ((d[:, 0] > 0).to(torch.int64) * 4 + (d[:, 1] > 0).to(torch.int64) * 2
              + (d[:, 2] > 0).to(torch.int64))
    ad = torch.abs(d) + 1e-30
    dmax = torch.amax(ad, dim=1, keepdim=True)
    u = (ad / dmax * 3.999).to(torch.int64)  # [R, 3] each in 0..3
    dbucket = (octant << 4) | (u[:, 1] << 2) | u[:, 2]
    return ((dbucket << 24) | morton) & _MASK


def _footprint_sort_keys(o, d, mesh, *, allow_negative: bool):
    """Sort key per ray: which of accel.N_SUPER superclusters (contiguous runs of
    the Morton-ordered clusters) the ray enters, in the high bits, and the
    spatial key below, so a tile's union of entered clusters approaches
    one ray's. Bitwise the JAX package's."""
    sc_lo, sc_hi = accel.supercluster_boxes(
        *mesh.bounds(mirrored=allow_negative))
    n_sc = sc_lo.shape[0]
    amask, _ = accel.ray_aabb_entry(o, d, sc_lo, sc_hi,
                                    allow_negative=allow_negative)
    weights = 1 << torch.arange(n_sc, dtype=torch.int64, device=o.device)
    scmask = torch.where(amask, weights[None, :], 0).sum(dim=1)
    spatial = _spatial_sort_keys(o, d, mesh.aabb_lo.amin(0),
                                 mesh.aabb_hi.amax(0))
    return ((scmask << (32 - n_sc)) & _MASK) | (spatial >> n_sc)


def footprint_keys_torch(o, d, mesh, live=None, *, allow_negative: bool):
    """The keys `_sort_rays` sorts by, in int64 tensor ops: the footprint
    key, or _DEAD where `live` (float32 [R] or None) is not > 0. The plain
    version of the sort-key kernel (ops/cuda/glue.py)."""
    keys = _footprint_sort_keys(o, d, mesh, allow_negative=allow_negative)
    return keys if live is None else torch.where(live > 0, keys, _DEAD)


@profiling.spanned("sort")
def _sort_rays(o, d, mesh, quirks: Quirks, live):
    """(order, live_sorted): the footprint order of the rays (dead rays
    last) and the live mask in that order (None when all are live). The
    keys come from the sort-key kernel on CUDA tensors and from
    `footprint_keys_torch` elsewhere."""
    allow_negative = quirks.reference_triangle_test
    if o.device.type == "cuda":
        table = mesh.sort_table(mirrored=allow_negative)
        keys = glue.sort_keys_kernel(o, d, table, live,
                                     mode=glue.KEY_FOOTPRINT,
                                     allow_negative=allow_negative)
    else:
        keys = footprint_keys_torch(o, d, mesh, live,
                                    allow_negative=allow_negative)
    order = torch.sort(keys, stable=True).indices
    return order, None if live is None else live[order]


def _unsort(x, order):
    """x [R, ...] in sorted order -> original order."""
    out = torch.empty_like(x)
    out[order] = x
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _culled_t(det, u_num, v_num, t_num, clip: bool):
    """csrc/mesh_math.cuh `culled_t`: rational barycentric tests, one
    division for t, the clean near clip; t or BIG."""
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    det2 = det * det
    valid = ok & (u_num * det >= 0) & (v_num * det >= 0) & (
        (u_num + v_num) * det <= det2)
    t = t_num / torch.where(ok, det, 1.0)
    if clip:
        valid = valid & (t > CLEAN_T_EPS)
    return torch.where(valid, t, BIG)


def _occludes(det, u_num, v_num, t_num, t_clip: float, bound):
    """csrc/mesh_math.cuh `occludes`: the division-free any-hit test with
    the window t_clip < t < bound."""
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    det2 = det * det
    td = t_num * det
    return (ok & (u_num * det >= 0) & (v_num * det >= 0)
            & ((u_num + v_num) * det <= det2) & (td > t_clip * det2)
            & (td < bound[:, None] * det2))


def _chunks(n_rays: int, n_tris: int, device):
    step = max(1, PLAIN_BLOCK[device.type] // max(n_tris, 1))
    return range(0, n_rays, step), step


def culled_nearest_torch(feats, rec, live=None, *, sign: float, clip: bool):
    """Plain version of K3: (t [R] (BIG = miss), original index [R] int32
    (BIG_I on a miss)) of features [R, 10] against every record of `rec`
    [..., 20]. An exact-t tie goes to the minimum original index, and only
    for a hit. Dead rays miss."""
    rec = rec.reshape(-1, REC)
    orig = rec[:, REC - 1].to(torch.int32)
    ts, idxs = [], []
    starts, step = _chunks(feats.shape[0], rec.shape[0], feats.device)
    for r0 in starts:
        t_all = _culled_t(*planes_torch(feats[r0:r0 + step], rec, sign), clip)
        t = t_all.amin(dim=1)
        idx = torch.where(t_all == t[:, None], orig[None, :], BIG_I).amin(dim=1)
        ts.append(t)
        idxs.append(torch.where(t < BIG, idx, BIG_I))
    t, idx = torch.cat(ts), torch.cat(idxs)
    if live is not None:
        dead = live == 0
        t = torch.where(dead, BIG, t)
        idx = torch.where(dead, BIG_I, idx)
    return t, idx


def culled_occluded_torch(feats, bound, rec, live=None, *, sign: float,
                          t_clip: float):
    """Plain version of K4: [R] bool, is any record hit strictly inside
    (t_clip, bound)? Dead rays are not occluded."""
    rec = rec.reshape(-1, REC)
    occ = []
    starts, step = _chunks(feats.shape[0], rec.shape[0], feats.device)
    for r0 in starts:
        f = feats[r0:r0 + step]
        occ.append(_occludes(*planes_torch(f, rec, sign), t_clip,
                             bound[r0:r0 + step]).any(dim=1))
    occ = torch.cat(occ)
    if live is not None:
        occ = occ & (live != 0)
    return occ


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_lib = None


def bind(lib):
    """Declares `culled_nearest` and `culled_occluded` of a loaded
    library."""
    lib.culled_nearest.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 10)
    lib.culled_occluded.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 10)
    for f in (lib.culled_nearest, lib.culled_occluded):
        f.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (if needed) and load the CUDA kernel library."""
    global _lib
    if _lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        _lib = bind(load_cuda("culled"))
    return _lib


def occluded_lanes() -> int:
    """Lanes per ray K4's launcher takes at every wave size (csrc/culled.cu
    kOccludedLanes, read from this tree's library)."""
    from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

    return int(load_cuda("culled").culled_occluded_lanes_per_ray())


def _check_operands(name, feats, mesh, extra):
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: CUDA tensors, got {dev}")
    tensors = [feats, mesh.rec, mesh.kern_lo, mesh.root] + [
        x for x in extra if x is not None]
    for x in tensors:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} kernel: contiguous float32 operands on "
                             f"{dev}, got {x.dtype} on {x.device}")
    R = feats.shape[0]
    if feats.dim() != 2 or feats.shape[1] != 10:
        raise ValueError(f"{name} kernel: feats [R, 10], got "
                         f"{tuple(feats.shape)}")
    for x in extra:
        if x is not None and tuple(x.shape) != (R,):
            raise ValueError(f"{name} kernel: per-ray operand [{R}], got "
                             f"{tuple(x.shape)}")
    if mesh.rec.data_ptr() % 16:
        raise ValueError(f"{name} kernel: triangle records must be 16-byte "
                         f"aligned")
    if R >= 2**31:
        raise ValueError(f"{name} kernel: fewer than 2^31 rays")


def _launch_common(mesh, quirks: Quirks):
    lo, hi, root = mesh.kernel_boxes(mirrored=quirks.reference_triangle_test)
    C, cs = mesh.n_clusters, mesh.cluster_size
    return (C, cs, int(quirks.reference_triangle_test)), (mesh.rec, lo, hi,
                                                          root)


@profiling.spanned("launch.k3")
def culled_nearest_kernel(feats, mesh, live, *, quirks: Quirks):
    """K3 on CUDA tensors: (t, original index) as `culled_nearest_torch`;
    counted in LAUNCHES["culled_nearest"], and while spans record in the
    device counters (`profiling.walk_counters`)."""
    _check_operands("culled_nearest", feats, mesh, [live])
    lib = build_kernel()
    dims, tabs = _launch_common(mesh, quirks)
    R = feats.shape[0]
    launch_shape(R, dims[0], dims[1])
    t = torch.empty(R, dtype=torch.float32, device=feats.device)
    idx = torch.empty(R, dtype=torch.int32, device=feats.device)
    sign = 1.0 if quirks.reference_triangle_test else -1.0
    clip = not quirks.reference_triangle_test
    args = (R, *dims, int(clip), sign, CLEAN_T_EPS, feats.data_ptr(),
            None if live is None else live.data_ptr(),
            *(x.data_ptr() for x in tabs), t.data_ptr(), idx.data_ptr())
    with torch.cuda.device(feats.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(feats.device).cuda_stream)
        ctr = profiling.walk_counters(feats.device, "k3")
        err = lib.culled_nearest(*args, stream, ctr)
    if err != 0:
        raise RuntimeError(f"culled_nearest kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["culled_nearest"] += 1
    check_outputs("culled_nearest", t, idx)
    return t, idx


@profiling.spanned("launch.k4")
def culled_occluded_kernel(feats, bound, mesh, live, *, quirks: Quirks,
                           t_clip: float):
    """K4 on CUDA tensors: [R] bool as `culled_occluded_torch`; counted in
    LAUNCHES["culled_occluded"], and while spans record in the device
    counters."""
    _check_operands("culled_occluded", feats, mesh, [bound, live])
    lib = build_kernel()
    dims, tabs = _launch_common(mesh, quirks)
    R = feats.shape[0]
    launch_shape(R, dims[0], dims[1], occluded_lanes())
    occ = torch.empty(R, dtype=torch.float32, device=feats.device)
    sign = 1.0 if quirks.reference_triangle_test else -1.0
    args = (R, *dims, sign, t_clip, feats.data_ptr(), bound.data_ptr(),
            None if live is None else live.data_ptr(),
            *(x.data_ptr() for x in tabs), occ.data_ptr())
    with torch.cuda.device(feats.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(feats.device).cuda_stream)
        ctr = profiling.walk_counters(feats.device, "k4")
        err = lib.culled_occluded(*args, stream, ctr)
    if err != 0:
        raise RuntimeError(f"culled_occluded kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["culled_occluded"] += 1
    check_outputs("culled_occluded", occ)
    return occ > 0.5


def _live_f32(live):
    return None if live is None else (live > 0).to(torch.float32).contiguous()


def triangle_nearest_culled(o, d, mesh: accel.ClusteredMesh, *,
                            quirks: Quirks, reorder: bool = True, live=None):
    """(t [R] (inf = miss), original index [R] int64 (clamped to the
    clustered table), hit [R] bool): nearest triangle via the culled
    kernel K3. `live` [R]: nonzero where the result is used; dead rays
    miss. `reorder` sorts the rays by footprint first (results do not
    change)."""
    feats = _ray_features10(o, d)
    live = _live_f32(live)
    order = None
    if reorder:
        order, live = _sort_rays(o, d, mesh, quirks, live)
        feats = feats[order]
    feats = feats.contiguous()
    if feats.device.type == "cpu":
        t, idx = culled_nearest_torch(
            feats, mesh.rec, live, sign=1.0 if quirks.reference_triangle_test
            else -1.0, clip=not quirks.reference_triangle_test)
    else:
        t, idx = culled_nearest_kernel(feats, mesh, live, quirks=quirks)
    if order is not None:
        t, idx = _unsort(t, order), _unsort(idx, order)
    hit = t < BIG
    idx = torch.clamp(idx.to(torch.int64), max=mesh.perm.shape[0] - 1)
    return torch.where(hit, t, float("inf")), idx, hit


def triangle_occluded(o, d, mesh: accel.ClusteredMesh, *, quirks: Quirks,
                      t_max=None, live=None, reorder: bool = True):
    """[R] bool: is any triangle strictly between t_clip and t_max along
    each ray (the culled any-hit kernel K4)? t_max [R] or None
    (unbounded). Clean-mode triangle occlusion: parity's shadows scan
    spheres only and never come here."""
    R = o.shape[0]
    bound = (torch.full((R,), BIG, dtype=torch.float32, device=o.device)
             if t_max is None else t_max.to(torch.float32))
    return occluded_features(_ray_features10(o, d), bound, mesh,
                             quirks=quirks, live=_live_f32(live),
                             reorder=reorder)


def occluded_features(feats, bound, mesh: accel.ClusteredMesh, *,
                      quirks: Quirks, live=None, reorder: bool = True):
    """`triangle_occluded` of rays given by their feature rows [R, 10]
    (`_ray_features10`: d, o x d, o, 1) and bounds [R] float32 (BIG:
    unbounded); live [R] float32 of 0.0 and 1.0, or None. The split
    route's hit-shading kernel writes these for K4 (ops/cuda/glue.py)."""
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    order = None
    if reorder:
        order, live = _sort_rays(feats[:, 6:9], feats[:, 0:3], mesh, quirks,
                                 live)
        feats, bound = feats[order], bound[order]
    feats, bound = feats.contiguous(), bound.contiguous()
    if feats.device.type == "cpu":
        occ = culled_occluded_torch(
            feats, bound, mesh.rec, live,
            sign=1.0 if quirks.reference_triangle_test else -1.0,
            t_clip=t_clip)
    else:
        occ = culled_occluded_kernel(feats, bound, mesh, live, quirks=quirks,
                                     t_clip=t_clip)
    return occ if order is None else _unsort(occ, order)

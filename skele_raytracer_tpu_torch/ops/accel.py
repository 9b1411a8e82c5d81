"""Triangle-mesh acceleration: Morton-ordered clusters + AABB culling (the
JAX package's ops/accel.py).

The reference scans every triangle for every ray (src/raytrace.h:170-187;
dragon.scn = 10,002 triangles). Here, as in the JAX package, the mesh is
sorted along a Morton curve of the triangle centroids and cut into
fixed-size clusters with one box each (`build_clusters`, NumPy, once per
mesh); the culled kernels (ops/cuda/culled.py) then test a ray only
against the clusters whose boxes it enters.

`build_clusters` is the JAX package's, operation for operation, so every
field it shares with that package's `ClusteredMesh` is bitwise equal. The
TPU kernels' folded [C, 10, 4, cs] blocks (`k10`: 19 distinct floats
padded to 40 per triangle for the TPU's lanes) are replaced by a compact
record per triangle, `rec` [C, cs, 20]: the nonzeros of `k10` in the
order csrc/mesh_math.cuh reads them, plus the original index. `k10` and
`org` remain available as properties derived from `rec`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from skele_raytracer_tpu_torch.scene.types import _Tensors
from skele_raytracer_tpu_torch.utils import profiling

CLUSTER_SIZE = 256  # triangles per cluster for coherent (primary) waves
FINE_CLUSTER_SIZE = 128  # for incoherent (bounce / bounce-shadow) waves

REC = 20  # floats per triangle record (csrc/mesh_math.cuh)

# Margin, relative to the mesh's coordinate scale, by which the boxes the
# culled kernels test are widened: rounding in the Moller-Trumbore t and in
# the slab test must never cull a hit (the kernels' answers then match the
# brute-force plain versions).
KERNEL_BOX_MARGIN = 1e-4

N_SUPER = 16  # footprint-key superclusters (high bits of the sort key)

# (row in k10's 10 feature rows, column in its 4 planes) of each record
# slot 0..18: A, B, -e2, -C, -e1, D, -kof.
_K10_SLOTS = ([(r, 0) for r in range(3)] + [(r, 1) for r in range(3)]
              + [(r, 1) for r in range(3, 6)] + [(r, 2) for r in range(3)]
              + [(r, 2) for r in range(3, 6)] + [(r, 3) for r in range(6, 9)]
              + [(9, 3)])


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points normalized to [0, 1)^3. x: [N, 3]."""
    q = np.clip((x * 1024.0), 0, 1023).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    return (
        (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    )


@dataclass
class ClusteredMesh(_Tensors):
    """Triangles reordered into spatial clusters, plus cluster boxes.

    v0/v1/v2/mask [Tc, 3]/[Tc]: Morton-sorted, padded to a multiple of the
    cluster size (padding rows have mask 0). perm [Tc] float32: original
    triangle index per sorted row (padding rows point at 0). aabb_lo/hi
    [C, 3]: tight cluster boxes; aabb_lo_m/hi_m: mirror-extended boxes for
    parity (they also cover 2 v0 - v1 and 2 v0 - v2: the reference's
    mirrored-u test accepts hits outside the true triangle). Empty
    clusters carry lo = 1 > hi = 0.

    rec [C, cs, 20]: the kernels' triangle records (module docstring), with
    the mask folded in (masked rows are all zero). kern_lo/kern_hi and
    kern_lo_m/kern_hi_m [C, 3]: the boxes widened by KERNEL_BOX_MARGIN, as
    the culled kernels test them; root/root_m [6]: the union of those
    (lo then hi). key_table/key_table_m [6 n_sc + 6]: the ray sort keys'
    boxes (`key_table`), from the tight / mirror-extended cluster boxes."""

    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    mask: torch.Tensor
    perm: torch.Tensor
    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor
    aabb_lo_m: torch.Tensor
    aabb_hi_m: torch.Tensor
    rec: torch.Tensor
    kern_lo: torch.Tensor
    kern_hi: torch.Tensor
    kern_lo_m: torch.Tensor
    kern_hi_m: torch.Tensor
    root: torch.Tensor
    root_m: torch.Tensor
    key_table: torch.Tensor
    key_table_m: torch.Tensor

    @property
    def n_clusters(self) -> int:
        return self.aabb_lo.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.rec.shape[1]

    def bounds(self, *, mirrored: bool):
        """(lo, hi): mirror-extended for parity's test, tight otherwise."""
        if mirrored:
            return self.aabb_lo_m, self.aabb_hi_m
        return self.aabb_lo, self.aabb_hi

    def kernel_boxes(self, *, mirrored: bool):
        """(lo, hi, root): the widened boxes the culled kernels test."""
        if mirrored:
            return self.kern_lo_m, self.kern_hi_m, self.root_m
        return self.kern_lo, self.kern_hi, self.root

    def sort_table(self, *, mirrored: bool) -> torch.Tensor:
        """The sort-key kernel's table (ops/cuda/glue.py): the supercluster
        boxes of the mirror-extended boxes for parity's test, of the tight
        ones otherwise, then the mesh box."""
        return self.key_table_m if mirrored else self.key_table

    @property
    def k10(self) -> torch.Tensor:
        """The JAX package's folded blocks [C, 10, 4, cs], from `rec`."""
        C, cs = self.rec.shape[:2]
        k10 = torch.zeros((C, 10, 4, cs), dtype=torch.float32,
                          device=self.rec.device)
        for s, (row, col) in enumerate(_K10_SLOTS):
            k10[:, row, col, :] = self.rec[:, :, s]
        return k10

    @property
    def org(self) -> torch.Tensor:
        """Original triangle index per sorted row, [C, 1, cs] float32."""
        return self.rec[:, None, :, REC - 1].contiguous()


def records_from_k10(k10: np.ndarray, org: np.ndarray) -> np.ndarray:
    """[C, cs, 20] records from the JAX package's k10 [C, 10, 4, cs] and
    org [C, 1, cs] (the inverse of ClusteredMesh.k10/org)."""
    k10 = np.asarray(k10, np.float32)
    cols = [k10[:, row, col, :] for row, col in _K10_SLOTS]
    cols.append(np.asarray(org, np.float32)[:, 0, :])
    return np.stack(cols, axis=-1)


def _widened(lo: np.ndarray, hi: np.ndarray, margin: float):
    """Boxes grown by `margin` on every side; empty boxes stay empty."""
    full = (lo <= hi).all(axis=1, keepdims=True)
    return (np.where(full, lo - margin, lo).astype(np.float32),
            np.where(full, hi + margin, hi).astype(np.float32))


def supercluster_boxes(lo: torch.Tensor, hi: torch.Tensor):
    """(lo, hi) [n_sc, 3] of the N_SUPER superclusters (contiguous runs of
    the Morton-ordered clusters; n_sc = min(N_SUPER, C)) of cluster boxes
    lo, hi [C, 3]: the high bits of the footprint sort key
    (ops/cuda/culled.py)."""
    C = lo.shape[0]
    n_sc = min(N_SUPER, C)
    g = -(-C // n_sc)
    pad = n_sc * g - C
    # empty boxes (lo = 1 > hi = 0) pad the last group: a box only grows
    lo_p = torch.cat([lo, lo.new_ones((pad, 3))])
    hi_p = torch.cat([hi, hi.new_zeros((pad, 3))])
    return (lo_p.reshape(n_sc, g, 3).amin(dim=1),
            hi_p.reshape(n_sc, g, 3).amax(dim=1))


def key_table(lo, hi, mesh_lo, mesh_hi) -> torch.Tensor:
    """float32 [6 n_sc + 6]: the supercluster boxes of cluster boxes lo, hi
    [C, 3] (their lo, then their hi), then the mesh box of the tight boxes
    mesh_lo, mesh_hi [C, 3]: the boxes of the ray sort keys, built once per
    mesh (ClusteredMesh.key_table)."""
    sc_lo, sc_hi = supercluster_boxes(lo, hi)
    return torch.cat([sc_lo.reshape(-1), sc_hi.reshape(-1),
                      mesh_lo.amin(0), mesh_hi.amax(0)])


def mesh_from_arrays(v0, v1, v2, mask, perm, aabb_lo, aabb_hi, aabb_lo_m,
                     aabb_hi_m, rec, device="cpu") -> ClusteredMesh:
    """A ClusteredMesh from NumPy arrays, with its kernel boxes."""
    lo_t, hi_t = np.asarray(aabb_lo), np.asarray(aabb_hi)
    lo_m, hi_m = np.asarray(aabb_lo_m), np.asarray(aabb_hi_m)
    full = (lo_m <= hi_m).all(axis=1)
    scale = float(np.abs(np.concatenate([lo_m[full], hi_m[full]])).max()
                  if full.any() else 1.0)
    margin = np.float32(KERNEL_BOX_MARGIN * max(scale, 1e-3))
    k_lo, k_hi = _widened(lo_t, hi_t, margin)
    k_lo_m, k_hi_m = _widened(lo_m, hi_m, margin)
    root = np.concatenate([k_lo.min(0), k_hi.max(0)])
    root_m = np.concatenate([k_lo_m.min(0), k_hi_m.max(0)])
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    lo_t, hi_t, lo_m, hi_m = t(lo_t), t(hi_t), t(lo_m), t(hi_m)
    return ClusteredMesh(
        v0=t(v0), v1=t(v1), v2=t(v2), mask=t(mask), perm=t(perm),
        aabb_lo=lo_t, aabb_hi=hi_t, aabb_lo_m=lo_m, aabb_hi_m=hi_m,
        rec=t(rec), kern_lo=t(k_lo), kern_hi=t(k_hi), kern_lo_m=t(k_lo_m),
        kern_hi_m=t(k_hi_m), root=t(root), root_m=t(root_m),
        key_table=key_table(lo_t, hi_t, lo_t, hi_t),
        key_table_m=key_table(lo_m, hi_m, lo_t, hi_t))


@profiling.timed_counter("scene.clusters_s")
def build_clusters(v0, v1, v2, mask, cluster_size: int = CLUSTER_SIZE,
                   device=None) -> ClusteredMesh:
    """Host-side build: Morton sort + cluster boxes + triangle records.
    Inputs are the padded scene arrays ([T, 3] x3 + mask, tensors or
    arrays); padding rows sort to dedicated all-padding clusters (their
    boxes are empty -> never hit). The mesh lands on `device` (default:
    the device of v0). Its seconds add to the counter `scene.clusters_s`
    (utils/profiling.py)."""
    if device is None:
        device = v0.device if isinstance(v0, torch.Tensor) else "cpu"
    v0n, v1n, v2n, m = (as_numpy(a) for a in (v0, v1, v2, mask))
    real = m > 0
    cent = (v0n + v1n + v2n) / 3.0
    lo = cent[real].min(axis=0) if real.any() else np.zeros(3)
    hi = cent[real].max(axis=0) if real.any() else np.ones(3)
    span = np.maximum(hi - lo, 1e-9)
    codes = _morton3((cent - lo) / span)
    codes = np.where(real, codes, np.uint32(0xFFFFFFFF))  # padding sorts last
    order = np.argsort(codes, kind="stable").astype(np.int32)
    return clusters_from_order(v0n, v1n, v2n, m, order, cluster_size, device)


def as_numpy(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def clusters_from_order(v0, v1, v2, mask, order, cluster_size: int,
                        device="cpu") -> ClusteredMesh:
    """The ClusteredMesh of the padded scene arrays (`build_clusters`'
    inputs) taken in `order` (an int32 permutation of their rows, padding
    rows last), cut into clusters of `cluster_size`: padding, boxes and
    triangle records as `build_clusters` makes them from its Morton
    order."""
    v0n, v1n, v2n, m = (as_numpy(a) for a in (v0, v1, v2, mask))
    T = v0n.shape[0]
    tc = -(-T // cluster_size) * cluster_size
    pad = tc - T
    order_p = np.concatenate([order, np.zeros(pad, np.int32)])
    take = lambda a: np.concatenate(
        [a[order], np.zeros((pad,) + a.shape[1:], a.dtype)])
    sv0, sv1, sv2 = take(v0n), take(v1n), take(v2n)
    sm = np.concatenate([m[order], np.zeros(pad, m.dtype)])

    C = tc // cluster_size
    cm = sm.reshape(C, cluster_size)
    empty = (cm > 0).sum(axis=1) == 0
    big = np.float32(3e38)

    def bounds_of(point_sets):
        k = len(point_sets)
        pts = np.stack(point_sets, axis=1).reshape(C, cluster_size * k, 3)
        wide = np.repeat(cm, k, axis=1)[..., None]  # [C, k*cs, 1]
        lo_c = np.where(wide > 0, pts, big).min(axis=1)
        hi_c = np.where(wide > 0, pts, -big).max(axis=1)
        lo_c[empty] = 1.0  # empty boxes: lo > hi -> slab test always misses
        hi_c[empty] = 0.0
        return lo_c.astype(np.float32), hi_c.astype(np.float32)

    lo_c, hi_c = bounds_of([sv0, sv1, sv2])
    lo_m, hi_m = bounds_of([sv0, sv1, sv2, 2.0 * sv0 - sv1, 2.0 * sv0 - sv2])

    # Triangle records: the nonzeros of the JAX package's k10 blocks, with
    # the same NumPy expressions (and so the same bits).
    e1 = (sv1 - sv0).astype(np.float32)
    e2 = (sv2 - sv0).astype(np.float32)
    sv0f = sv0.astype(np.float32)
    Am = np.cross(e2, e1)
    Bm = np.cross(e2, sv0f)
    Cm = np.cross(sv0f, e1)
    Dm = np.cross(e1, e2)
    kof = np.sum(e2 * Cm, axis=1)
    rec = np.concatenate(
        [Am, Bm, -e2, -Cm, -e1, Dm, -kof[:, None]], axis=1).astype(np.float32)
    rec = rec * (sm > 0)[:, None]  # mask fold
    rec = np.concatenate(
        [rec, order_p.astype(np.float32)[:, None]], axis=1)
    rec = rec.reshape(C, cluster_size, REC)

    return mesh_from_arrays(sv0, sv1, sv2, sm, order_p, lo_c, hi_c, lo_m,
                            hi_m, rec, device=device)


def ray_aabb_entry(o, d, lo, hi, *, t_clip: float = 0.0,
                   allow_negative: bool = False):
    """([R, C] bool, [R, C] f32): slab test + entry distance per box.

    The entry (slab tmin, in ray-parameter units) is a lower bound on the t
    of any intersection inside that box; undefined for boxes not entered.
    The three axes are unrolled into pairwise min/max, as in the JAX
    package (bitwise the [R, C, 3] reduce form)."""
    tmin = tmax = None
    for a in range(3):
        d_a = d[:, a]
        inv_a = 1.0 / torch.where(d_a.abs() > 1e-30, d_a, 1e-30)
        t0 = (lo[None, :, a] - o[:, None, a]) * inv_a[:, None]
        t1 = (hi[None, :, a] - o[:, None, a]) * inv_a[:, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    hit = tmin <= tmax
    if not allow_negative:
        hit = hit & (tmax > t_clip)
    return hit, tmin


def ray_aabb_mask(o, d, lo, hi, *, t_clip: float = 0.0,
                  allow_negative: bool = False):
    """[R, C] bool: does ray (o, d) pass through each box?"""
    return ray_aabb_entry(o, d, lo, hi, t_clip=t_clip,
                          allow_negative=allow_negative)[0]

"""Speed of light on an NVIDIA H100: how close a kernel or a frame runs to
the card's ceilings, and which ceiling binds (the JAX package's
utils/roofline.py, with the H100's peaks in place of the TPU's).

Two views:

* the kernels' bounds (`k1_work`, `k2_work`, `mesh_work`, `occluded_work`,
  `k5_work`, `k6_work`, `fused_work`, `lab_work`): the least time the card could take
  for a kernel's work, the larger of its counted operations at each type's
  peak and the bytes it must move at HBM's rate (`roofline`). The
  operations are counted per sample or per ray-triangle pair from the
  kernels' arithmetic (the chip machine has no hardware counters);
  chip_smoke.py reports each kernel's time beside its bound;
* `frame_model(...)` and `sol_summary(...)`: an analytic cost of one
  Monte-Carlo frame (operations and the least HBM traffic) and the share
  of each ceiling a measured time reaches, from wall time and, where a
  profile gave it, from device time.
"""

from __future__ import annotations

import numpy as np
import torch

# Peak rates of one H100 SXM at 700 W for the bounds: FP32 and HBM from
# NVIDIA's data sheet; the SFU (sqrt, reciprocal, exp, log, sin, cos) at 16
# per SM per clock x 132 SMs x 1.98 GHz; INT32 at 64 lanes per SM (16 per
# SM sub-partition in the SM diagram of NVIDIA's Hopper architecture white
# paper) x 132 SMs x 1.98 GHz.
FP32_PEAK = 67e12
# Dense BF16 tensor-core rate of the H100 SXM (NVIDIA's H100 Tensor Core GPU
# data sheet: 1,979 TFLOP/s with sparsity, 989 dense), for the kernel lab's
# bf16x3 product (`lab_work`).
BF16_TC_PEAK = 989e12
INT32_PEAK = 64 * 132 * 1.98e9
SFU_PEAK = 16 * 132 * 1.98e9
HBM_PEAK = 3.35e12
PEAKS = {"fp32": FP32_PEAK, "sfu": SFU_PEAK, "int32": INT32_PEAK,
         "hbm": HBM_PEAK}  # operations/s, bytes/s


def roofline(fp32=0.0, sfu=0.0, int32=0.0, nbytes=0.0, mma=0.0):
    """(bound_ms, bound_by): the larger of the operations' time, each type
    at its peak (`mma`: BF16 tensor-core operations), and the bytes' time
    at HBM's rate."""
    ops_s = max(fp32 / FP32_PEAK, sfu / SFU_PEAK, int32 / INT32_PEAK,
                mma / BF16_TC_PEAK)
    mem_s = nbytes / HBM_PEAK
    return max(ops_s, mem_s) * 1e3, ("operations" if ops_s >= mem_s
                                     else "bytes")


def _w(f=0, s=0, i=0):
    return np.array([f, s, i], np.float64)  # fp32, sfu, int32 operations


def k1_sample_work(st, replay=False):
    """Operations of one sample of K1 (or, with replay, of one replay
    forward of K2): [fp32, sfu, int32], in K1's scan order (frame_math.cuh).
    Scans count every table row: a (ray, sphere) test ~20 FP32 operations
    and a square root, ~13 from the camera's staged rows (the primary
    scan), a (ray, triangle) test ~40 and a division. A shading point's
    shadow scans, one per light as the kernel runs them, count each sphere
    row's o - c and c (~8) and its test (~13), and each triangle row's
    origin half (~17) and the rest (~25), for every light; they are
    counted whole (they may stop at the first occluder). Rows that
    no lane of a warp can hit skip their square root: not counted (the
    square roots count in full). The replay has no scans (the recorded
    primitive's t instead)."""
    S, T = st["S"] * st["sph_on"], st["T"] * st["tri_on"]
    norm_dirs = not st["quirks"].unnormalized_ray_dirs
    draw = _w(i=70)  # one threefry2x32 call
    tris = _w(40 * T, T)
    scan = _w(20 * S, S) + tris
    hit_t0 = _w(30, 2) if replay else _w(13 * S, S) + tris
    hit_t = _w(30, 2) if replay else scan
    lights_on = st["point_on"] or st["dir_on"]
    n_lights = (st["L"] if st["point_on"] else 0) + (st["LD"] if st["dir_on"]
                                                     else 0)
    shade = _w(3)
    if lights_on:
        T_sh = 0 if st["quirks"].sphere_only_shadows else T
        occl = (n_lights * _w(21 * S + 42 * T_sh, S + T_sh)
                if st["use_shadows"] and not replay else _w())
        shade = shade + _w(12, 2) + occl
        if st["point_on"]:
            per = _w(40, 6)
            if st["F"]:
                per = _w(20, 3) + st["F"] * (4 * draw + _w(50, 2))
            shade = shade + st["L"] * per
        if st["dir_on"]:
            shade = shade + st["LD"] * _w(30, 4)
    geo = _w(25, 2)
    w = _w(20) + (_w(10, 2) if norm_dirs else 0) + (draw if st["grid"] else 0)
    w = w + hit_t0 + geo + shade + _w(10, 1)
    if st["mc"] and st["D"] > 1:
        w = w + _w(15, 4)
        for b in range(1, st["D"]):
            last = b == st["D"] - 1
            w = w + st["P"] * (draw + _w(26, 4) + (_w(10, 2) if norm_dirs
                                                   else 0) + hit_t + _w(12, 1)
                               + (geo if lights_on or not last else 0)
                               + (shade if lights_on else _w(3))
                               + (_w(15, 4) if not last else 0))
    return w


def k1_model(st, n, records=False):
    """K1's counted work over n samples as a `sol_summary` model: FP32
    ("flops"), SFU and INT32 operations and the bytes it must move."""
    f, sfu, i = k1_sample_work(st) * n
    tables = 4 * (st["S"] * 16 + st["T"] * 24 + (1 + st["F"]) * 24
                  + (st["L"] + st["LD"]) * 8)
    K = 1 + (st["P"] * (st["D"] - 1) if st["mc"] and st["D"] > 1 else 0)
    nbytes = n * (20 + 12 + (4 * K if records else 0)) + tables
    return {"flops": f, "sfu": sfu, "int32": i, "hbm_bytes_min": nbytes}


def k1_work(st, n, records=False):
    """(bound_ms, bound_by) of K1 over n samples."""
    m = k1_model(st, n, records)
    return roofline(m["flops"], m["sfu"], m["int32"], m["hbm_bytes_min"])


def k2_work(st, n):
    """(bound_ms, bound_by) of K2 over n samples: per sample the replay
    forward, the recompute of each path's earlier bounces (D(D-1)/2 per
    path) and an adjoint of about twice the replay's operations, plus the
    warp reductions (a staged row per record, a shuffle tree per light and
    misc value)."""
    fwd = k1_sample_work(st, replay=True)
    D, P = st["D"], st["P"]
    recompute = (P * (D - 1) * (D - 2) // 2 if st["mc"] and D > 2 else 0)
    per_bounce = fwd / max(1 + (P * (D - 1) if st["mc"] and D > 1 else 0), 1)
    K = 1 + (P * (D - 1) if st["mc"] and D > 1 else 0)
    lights = (st["L"] * st["point_on"] + st["LD"] * st["dir_on"])
    reduce_ops = K * (32 + lights * 7 * 5) + 28 * 5
    f, sfu, i = (3 * fwd + recompute * per_bounce + _w(reduce_ops)) * n
    E = (st["S"] * 16 + st["T"] * 24 + (1 + st["F"]) * 24
         + (st["L"] + st["LD"]) * 8)
    blocks = min(-(-n // 128), 1024)
    nbytes = n * (20 + 4 * K + 12) + 4 * E * (1 + 2 * blocks + 1)
    return roofline(f, sfu, i, nbytes)


def mesh_work(o, d, mesh, quirks, live=None):
    """(bound_ms, bound_by) of K3 on a wave: each live ray slab-tests every
    cluster box, then tests the triangles of the clusters whose (widened)
    box it enters."""
    from skele_raytracer_tpu_torch.ops import accel

    parity = quirks.reference_triangle_test
    lo, hi, _ = mesh.kernel_boxes(mirrored=parity)
    lv = (torch.ones(o.shape[0], device=o.device) if live is None
          else (live > 0).float())
    C = mesh.n_clusters
    per_cluster = (mesh.mask.reshape(C, -1) > 0).sum(1).float()
    pairs = 0.0
    for i in range(0, o.shape[0], 8192):
        m = accel.ray_aabb_mask(o[i:i + 8192], d[i:i + 8192], lo, hi,
                                allow_negative=parity).float()
        pairs += float(((m @ per_cluster) * lv[i:i + 8192]).sum())
    rays = float(lv.sum())
    nbytes = o.shape[0] * (40 + 8 + 8) + float(mesh.rec.numel()) * 4
    return roofline(rays * C * 20 + pairs * 40, rays * 3 + pairs, 0, nbytes)


def occluded_work(o, d, mesh, quirks, live=None, t_max=None, chunk=4096):
    """(bound_ms, bound_by) of K4 on a wave, from what this wave's data
    needs: each live ray slab-tests every cluster box, then tests the
    triangles of the clusters its shadow ray enters before its bound, front
    to back, up to and including the first cluster that holds an occluder
    (an any-hit test stops there; ~40 FP32 operations per pair, no
    division)."""
    from skele_raytracer_tpu_torch.config import CLEAN_T_EPS
    from skele_raytracer_tpu_torch.ops import accel
    from skele_raytracer_tpu_torch.ops.cuda import culled

    parity = quirks.reference_triangle_test
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    lo, hi, _ = mesh.kernel_boxes(mirrored=parity)
    C = mesh.n_clusters
    per_cluster = (mesh.mask.reshape(C, -1) > 0).sum(1).float()
    rec = mesh.rec.reshape(-1, 20)
    bound = (torch.full((o.shape[0],), culled.BIG, device=o.device)
             if t_max is None else t_max)
    idx = (torch.arange(o.shape[0], device=o.device) if live is None
           else (live > 0).nonzero().flatten())
    pairs = 0.0
    for i in range(0, idx.numel(), chunk):
        k = idx[i:i + chunk]
        m, tmin = accel.ray_aabb_entry(o[k], d[k], lo, hi, t_clip=t_clip)
        m = m & (tmin < bound[k, None])
        feats = culled._ray_features10(o[k], d[k])
        occ = culled._occludes(*culled.planes_torch(
            feats, rec, 1.0 if parity else -1.0), t_clip, bound[k])
        occ = occ.reshape(k.numel(), C, -1).any(-1) & m
        first = torch.where(occ, tmin, float("inf")).amin(1, keepdim=True)
        pairs += float(((m & (tmin <= first)).float() @ per_cluster).sum())
    rays = float(idx.numel())
    nbytes = o.shape[0] * (40 + 4 + 4 + 4) + float(mesh.rec.numel()) * 4
    return roofline(rays * C * 20 + pairs * 40, rays * 3, 0, nbytes)


def k5_work(n_rays, n_tris):
    """(bound_ms, bound_by) of K5: every (ray, triangle) pair."""
    pairs = float(n_rays) * n_tris
    return roofline(pairs * 40, pairs, 0, n_rays * (36 + 20) + n_tris * 9 * 16)


def k6_work(n_rays, n_sph):
    """(bound_ms, bound_by) of K6's one-launch entry: every (ray, sphere)
    pair, ~26 FP32 operations, a square root and a division each, and the
    ray's three dot products; o and d (24 B) in and t, the int64 index and
    hit (13 B) out per ray, center, radius and mask (20 B) per sphere."""
    pairs = float(n_rays) * n_sph
    return roofline(pairs * 26 + n_rays * 15.0, pairs * 2, 0,
                    n_rays * (24 + 13) + n_sph * 20)


def k6_skip_share(o, d, rows, lanes, tile=256, chunk=1 << 18):
    """The share of K6's (ray, sphere) pairs whose square root, division
    and tests its warp-uniform skip leaves out at `lanes` per ray, for rays
    o, d [R, 3] and sphere rows [S, 5] (ops/cuda/intersect.py
    `sphere_rows`): csrc/intersect.cu `sphere_nearest_kernel`'s warps of 32
    / lanes rays (rays past R padded as the kernel pads them, to a block of
    256 / lanes), its steps (lane l takes row k lanes + l of each tile of
    `tile` rows, the tile's last row past its end) and its vote on disc >=
    0, with the discriminant computed as the kernel computes it."""
    from skele_raytracer_tpu_torch.ops.cuda.intersect import (
        sphere_disc_torch,
    )

    n, S = o.shape[0], rows.shape[0]
    w = 32 // lanes
    n_pad = -(-n // (256 // lanes)) * (256 // lanes)
    o = torch.cat([o, o.new_zeros(n_pad - n, 3)])
    d = torch.cat([d, d.new_ones(n_pad - n, 3)])
    real_ray = (torch.arange(n_pad, device=o.device) < n).reshape(-1, w)
    skipped = 0
    for base in range(0, S, tile):
        ns = min(S - base, tile)
        steps = -(-ns // lanes)
        j = torch.arange(steps * lanes, device=o.device)
        cols = base + j.clamp(max=ns - 1)
        real_row = (j < ns).reshape(steps, lanes)
        for r0 in range(0, n_pad, chunk):  # chunk: a multiple of a block
            _, _, disc = sphere_disc_torch(o[r0:r0 + chunk],
                                           d[r0:r0 + chunk], rows[cols])
            vote = (disc >= 0).reshape(-1, w, steps, lanes).any(3).any(1)
            pairs = (real_ray[r0 // w:(r0 + chunk) // w].sum(1)[:, None]
                     * real_row.sum(1)[None, :])  # [warps, steps]
            skipped += int((pairs * ~vote).sum())
    return skipped / (float(n) * S)


def fused_work(o, d, scene, outs, use_shadows, live=None, chunk=4096):
    """(bound_ms, bound_by) of K7 on a wave, from what this wave's data
    needs: each live ray slab-tests every cluster box and tests the
    triangles of the clusters it enters up to its hit (entry <= its t),
    scans every sphere, shades; per unmasked light with shadows, each ray
    that hit slab-tests every box and tests the triangles of the clusters
    its shadow ray enters before the bound, up to the first cluster that
    holds an occluder; every ray scans the spheres once more per light.
    `outs`: the wave's fused_shade_forward outputs."""
    from skele_raytracer_tpu_torch.ops import accel
    from skele_raytracer_tpu_torch.ops.cuda import megakernel as mk
    from skele_raytracer_tpu_torch.ops.geometry import (
        cross,
        hit_geometry,
        offset_origin,
    )

    mesh = scene.clusters
    lo, hi, _ = mesh.kernel_boxes(mirrored=False)
    C = mesh.n_clusters
    per_cluster = (mesh.mask.reshape(C, -1) > 0).sum(1).float()
    rec = mesh.rec.reshape(-1, 20)
    _, t, kind, index, _ = outs
    lv = (torch.ones(o.shape[0], device=o.device, dtype=torch.bool)
          if live is None else live > 0)
    rays = float(lv.sum())
    hit = lv & (kind > 0)
    t_hit = torch.where(torch.isfinite(t), t, 3.0e38)
    point, normal = hit_geometry(o, d, scene, kind, index, t)
    sh = offset_origin(point, normal)
    lights, n_point = mk.pack_lights(scene)
    S, L = scene.spheres.mask.shape[0], lights.shape[0]
    pairs, sh_tests, sh_pairs = 0.0, 0.0, 0.0
    for i in range(0, o.shape[0], chunk):
        sl = slice(i, i + chunk)
        m, tmin = accel.ray_aabb_entry(o[sl], d[sl], lo, hi)
        m = m & (tmin <= t_hit[sl, None]) & lv[sl, None]
        pairs += float((m.float() @ per_cluster).sum())
        if not use_shadows:
            continue
        for li in range(L):
            if float(lights[li, 6]) <= 0:
                continue
            h = hit[sl]
            if li < n_point:
                v = lights[li, None, 0:3] - point[sl]
                bound = torch.sqrt(torch.clamp((v * v).sum(1), min=1e-30))
                ldir = v / bound[:, None]
            else:
                ldir = lights[li, None, 0:3].expand(h.shape[0], 3)
                bound = torch.full_like(t_hit[sl], 3.0e38)
            so = sh[sl][h]
            ld, bd = ldir[h], bound[h]
            if so.shape[0] == 0:
                continue
            sh_tests += float(so.shape[0])
            m, tmin = accel.ray_aabb_entry(so, ld, lo, hi, t_clip=1e-4)
            m = m & (tmin < bd[:, None])
            f = torch.cat([ld, cross(so, ld), so,
                           torch.ones_like(bd)[:, None]], 1)
            occ = (mk._brute_t(*mk.planes_torch(f, rec, -1.0), True)[0]
                   < bd[:, None]).reshape(-1, C, rec.shape[0] // C).any(-1)
            first = torch.where(occ.any(1), occ.float().argmax(1), C)
            upto = torch.arange(C, device=o.device)[None, :] <= first[:, None]
            sh_pairs += float(((m & upto).float() @ per_cluster).sum())
    passes = 1 + (L if use_shadows else 0)
    fp32 = (rays * C * 20 + pairs * 40 + rays * S * 26 * passes
            + rays * (40 + 60 * L) + sh_tests * C * 20 + sh_pairs * 40)
    sfu = (rays * 3 + pairs + rays * S * 2 * passes + rays * (4 + 5 * L)
           + sh_tests * 3 + sh_pairs)
    nbytes = (o.shape[0] * (40 + 4 + 12 + 12 + 4 * L) + rec.numel() * 4
              + scene.triangles.mask.shape[0] * 56 + S * 64 + L * 28)
    return roofline(fp32, sfu, 0, nbytes)


# operations per (ray, column) pair of the kernel lab (csrc/culled_lab.cu)
LAB_P6_PRODUCT = 34  # FP32: the numerators' 19 multiplies and 15 adds
LAB_EPILOGUE = 16  # FP32: K3's tests, the near clip, the mask, the update
LAB_MM_EPILOGUE = 2  # FP32: the probe's product stage, an add and a min


def lab_work(b, walked, *, kind: str, passes: int, group_c: int,
             stage: str = "loop"):
    """(bound_ms, bound_by) of a kernel-lab row (ops/cuda/lab.py) on batch
    b, from what this batch's walk tests: `walked` [T], the groups each
    tile walked (`lab_nearest_torch(..., walked=True)`), each TILE_R rays
    by group_c x cs columns. passes = 6: 34 FP32 operations per pair for
    the product; passes = 3: the bf16x3 product as tensor-core operations,
    3 products x 4 planes x a multiply-add per contraction row (10 folded,
    9 not: L5's zero rows are layout, not work), and the split of each
    walked column's constants into hi and lo (3 FP32 operations per value;
    none for L6, whose constants come split). The epilogue on FP32 and the
    SFU (the division), except the probe's product stage (an add and a
    min). Bytes: the features and the outputs, the shortlist tables, the
    boxes and every cluster's block as the kernel reads it (L5's 16 rows;
    L6's hi and lo bf16 in the bytes of one float32 block), each once."""
    from skele_raytracer_tpu_torch.ops.cuda import lab

    rows = 10 if kind in lab.FOLDED else 9
    block_rows, aux_rows = lab.ROWS[kind]
    T, C, cs = b.n_tiles, b.n_clusters, b.cluster_size
    columns = float(walked.sum()) * group_c * cs
    pairs = columns * lab.TILE_R
    fp32 = pairs * (LAB_MM_EPILOGUE if stage == "mm" else LAB_EPILOGUE)
    sfu = 0.0 if stage == "mm" else pairs
    mma = 0.0
    if passes == 6:
        fp32 += pairs * LAB_P6_PRODUCT
    else:
        mma = pairs * 3 * 4 * 2 * rows
        if kind != "lab_presplit":
            fp32 += columns * rows * 4 * 3
    nbytes = (T * lab.TILE_R * (40 + 8) + T * (C + C + 1 + 1) * 4
              + C * (block_rows * 4 * cs + aux_rows * cs) * 4 + C * 24)
    return roofline(fp32, sfu, 0, nbytes, mma)


# ---------------------------------------------------------------------------
# Analytic frame model (no trace needed)
# ---------------------------------------------------------------------------


def frame_model(*, width: int, height: int, paths: int, depth: int,
                s_pad: int, samples: int = 1):
    """Least work of one Monte-Carlo frame of a sphere scene (the 1080p
    headline's kind), the JAX package's segment arithmetic.

    Operations per ray segment (one bounce of models/integrator.py):
      sphere quadratic vs s_pad spheres  ~30 each
      nearest-select + one-hot gathers   ~8 * s_pad
      threefry2x32 sampling              ~250
      frame transform + state update     ~120
    HBM bytes per segment, the logical least: one read and one write of
    the live path state (origin, direction, throughput, radiance: 48 B
    each way), plus the frame written once. A kernel that keeps the path
    in registers (K1) moves less; `k1_model` counts what K1 moves."""
    segments = width * height * samples * (1 + paths * max(depth - 1, 1))
    flops_per_seg = 30 * s_pad + 8 * s_pad + 250 + 120
    hbm_per_seg = 2 * 48
    return {
        "segments": segments,
        "flops": segments * flops_per_seg,
        "hbm_bytes_min": segments * hbm_per_seg + width * height * 12,
    }


_CEILINGS = (("fp32", "flops"), ("sfu", "sfu"), ("int32", "int32"),
             ("hbm", "hbm_bytes_min"))


def _shares(model, seconds, peaks):
    flops_s = model["flops"] / seconds
    bw = model["hbm_bytes_min"] / seconds
    pct = {c: 100.0 * model[k] / seconds / peaks[c]
           for c, k in _CEILINGS if k in model}
    return {
        "seconds": seconds,
        "achieved_tflops": flops_s / 1e12,
        "hbm_min_gbps": bw / 1e9,
        **{f"{c}_pct": v for c, v in pct.items()},
        "bound": max(pct, key=pct.get),
    }


def sol_summary(model: dict, seconds: float, device_seconds=None,
                peaks=PEAKS):
    """The share of each H100 ceiling that `model`'s work reaches in
    `seconds` of wall time, and the binding ceiling (the largest share):
    FP32 ("flops") and HBM ("hbm_bytes_min") always, SFU and INT32 where
    the model counts them. With `device_seconds` (the kernels' busy time
    from a profile or CUDA events) the same shares from device time under
    "device", and the device's busy share of the wall time."""
    out = _shares(model, seconds, peaks)
    if device_seconds:
        out["device"] = _shares(model, device_seconds, peaks)
        out["device_busy_pct"] = 100.0 * device_seconds / seconds
    return out

"""Kernel lab: launch-level A/B harness for the nearest-hit lab kernels on
the card (the counterpart of the JAX package's tools/kernel_lab.py).

Builds one realistic dragon bounce-wave batch and runs the lab's rows on
it. The batch (`build_batch`): dragon.scn at 640x480, clean, gillum 16,
depth 2, shadows; 8,192 samples from id 819,200 through the camera, the
nearest hit and its shading (`integrator._shade_hit`), then 16 paths each
(`integrator._mc_continue`): 131,072 bounce rays with their live mask,
sorted by footprint key (dead rays last) into tiles of 256 rays, each
tile's shortlist the clusters its live rays enter, sorted by the tile's
smallest entry (`batch_from_rays`). The cluster boxes are the widened ones
K3 tests (`accel.KERNEL_BOX_MARGIN`; the TPU lab took the tight ones), so
that the lab's culls are conservative as K3's and its full-FP32 rows can
be held bitwise against K3.

Each row prints its device time per call, as the slope of 8 against 40
back-to-back calls under CUDA events (the least of 3 each; the slope
cancels the launch overhead, as the TPU lab's slope over in-program
repetitions cancelled its dispatch floor) beside profiler device time per
call (the sum of every kernel the call launches: L3's and L5's split walk
launches three), and `[OK]` or `MISMATCH t:n idx:n` against the port's
production K3 (`culled.culled_nearest_kernel` on the same sorted batch), over the
batch's live rays; bf16x3 rows (p3) also say whether they stay inside
their class against K3 (`p3_fp32_ok`: hit flags agree on 99.9% of the
rays, t within the bf16x3 product's error bound on the same triangle,
and every ray on another triangle an edge decision inside the product's
error band), and the first such row lists those rays. The `prod` row is
K3 itself.

    python -m skele_raytracer_tpu_torch.tools.kernel_lab [row ...]
    python -m skele_raytracer_tpu_torch.tools.kernel_lab flat_g2 presplit_g2
    python -m skele_raytracer_tpu_torch.tools.kernel_lab cs-sweep
    python -m skele_raytracer_tpu_torch.tools.kernel_lab items-sweep
    python -m skele_raytracer_tpu_torch.tools.kernel_lab --device cpu \\
        --samples 64

`cs-sweep` runs K3 at cluster sizes 256, 128 and 64 with tiles of 256 and
128 rays (the shortlists' mean length), unsorts its answers and holds
them against the first clustering's. `items-sweep` times the split walk's
rows (L3, L5) at 1-4 groups per work item and at one item per tile
(`items_sweep`). `--device cpu` runs the plain
versions (ops/cuda/lab.py) and K3's, with no timing; `--samples` cuts the
batch (a multiple of 16).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from skele_raytracer_tpu_torch.ops.cuda import lab

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DRAGON = os.path.join(REPO, "scenes", "dragon.scn")
TILE_R = lab.TILE_R
FIRST_ID = 100 * 8192  # the TPU lab's first sample id
# The bf16x3 (passes 3) classes. A p3 answer against another p3 answer
# (kernel against plain version: the same bf16 products, summed in another
# order; `p3_plain_ok`): hit flags agree on at least P3_HITS of the rays,
# indices on at least P3_SAME of the rays where both hit and wherever t
# agrees to P3_T_AGREE, and t within P3_PLAIN_REL relative where both hit
# the same triangle (the probe's product stage, which holds no hits:
# within P3_PLAIN_REL of the batch's largest value). A p3 answer against
# full FP32 (K3, or a p6 row; `p3_fp32_ok`): hit flags agree on at least
# P3_HITS of the rays, t within `p3_t_bound` (the bf16x3 product's error
# carried through t = t_num / det) where both hit the same triangle, and
# every ray whose hit or triangle differs is an edge decision inside the
# product's error band (`p3_flips`).
P3_HITS = 0.999
P3_SAME = 0.999
P3_T_AGREE = 1e-4
P3_PLAIN_REL = 1e-5
# The error of one bf16x3 plane sum relative to sum_r |f_r K_r|: the
# dropped lo.lo term and the lo parts' own rounding, 3 * 2^-18, and the
# FP32 sums of up to 10 terms on both sides, ~20 * 2^-24, are below 2^-16.
P3_EPS = 2.0 ** -16

# The TPU file's rows (tools/kernel_lab.py VARIANTS :373-384, :611-613,
# :731): row -> (kernel, arguments).
ROWS = {
    "lab_base": ("lab_base", dict(gate_settle=False)),
    "lab_gate": ("lab_base", dict(gate_settle=True)),
    "lab_thin": ("lab_base", dict(gate_settle=True, thin_epilogue=True)),
    "lab_noexit": ("lab_base", dict(gate_settle=False, no_early_exit=True)),
    "lab_3pass": ("lab_base", dict(gate_settle=False, passes=3)),
    "lab_3pass_noexit": ("lab_base", dict(gate_settle=False, passes=3,
                                          no_early_exit=True)),
    "flat_g2": ("lab_flat", dict(group_c=2, passes=6)),
    "flat_g2_3p": ("lab_flat", dict(group_c=2, passes=3)),
    "flat_g4_3p": ("lab_flat", dict(group_c=4, passes=3)),
    "presplit_g2": ("lab_presplit", dict(group_c=2, passes=3)),
}


def batch_from_rays(o, d, live, mesh, tile_r: int = TILE_R) -> dict:
    """A lab batch (the JAX lab's dict, NumPy) of rays (o, d) [R, 3] with
    live [R] bool over a ClusteredMesh: tools/kernel_lab.py `build`'s steps
    through the port's modules, on the rays' device."""
    from skele_raytracer_tpu_torch.ops import accel
    from skele_raytracer_tpu_torch.ops.cuda import culled
    from skele_raytracer_tpu_torch.ops.cuda.intersect import BIG, ray_features

    R, C = o.shape[0], mesh.n_clusters
    if R % tile_r:
        raise ValueError(f"{R} rays do not fill tiles of {tile_r}")
    feats = ray_features(o, d)
    keys = culled._footprint_sort_keys(o, d, mesh, allow_negative=False)
    keys = torch.where(live, keys, culled._DEAD)
    ray_order = torch.sort(keys, stable=True).indices
    feats_s, live_s = feats[ray_order], live[ray_order]
    lo, hi, _ = mesh.kernel_boxes(mirrored=False)
    amask, entry = accel.ray_aabb_entry(feats_s[:, 6:9], feats_s[:, 0:3], lo,
                                        hi, allow_negative=False)
    entry = torch.where(amask & live_s[:, None], entry, BIG)
    tile_entry = entry.reshape(R // tile_r, tile_r, C).amin(1)
    order = torch.argsort(tile_entry, dim=1, stable=True)
    counts = (tile_entry < BIG).sum(1)
    ent = torch.cat([torch.sort(tile_entry, dim=1).values,
                     torch.full_like(tile_entry[:, :1], BIG)], 1)
    kc, aux = lab.lab_tables(mesh.v0, mesh.v1, mesh.v2, mesh.mask, mesh.perm,
                             mesh.cluster_size)
    n = lambda x: x.detach().cpu().numpy()
    return dict(feats=n(feats_s), order=n(order).astype(np.int32),
                counts=n(counts).astype(np.int32), ent=n(ent), lo=n(lo),
                hi=n(hi), kc=kc, aux=aux, cs=mesh.cluster_size, C=C,
                live=n(live_s).astype(np.float32), ray_order=n(ray_order),
                tile_r=tile_r)


def build_batch(cluster_size: int = 128, tile_r: int = TILE_R,
                device: str = "cuda", samples: int = 8192, paths: int = 16,
                clustering=None):
    """(LabBatch, the ClusteredMesh, the batch's dict): the dragon bounce
    wave of `samples` samples from FIRST_ID times `paths` paths (module
    docstring) over dragon's triangles in clusters of `cluster_size`, in
    tiles of `tile_r` rays (the lab kernels take 256). `clustering` builds
    the mesh (`accel.build_clusters`' signature; by default Morton runs,
    accel.build_clusters itself; lab_median.py's `build_median`)."""
    from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
    from skele_raytracer_tpu_torch.models import integrator
    from skele_raytracer_tpu_torch.ops import accel
    from skele_raytracer_tpu_torch.ops.camera import rays_for_ids
    from skele_raytracer_tpu_torch.scene.parser import parse_scene

    cuda = torch.device(device).type == "cuda"
    cfg = RenderConfig(width=640, height=480, max_depth=2, use_shadows=True,
                       monte_carlo=True, num_paths=paths,
                       rays_per_chunk=1 << 17, quirks=CLEAN,
                       backend="cuda" if cuda else "torch")
    scene = parse_scene(DRAGON).to_scene(CLEAN, device=device)
    tri = scene.triangles
    mesh = (clustering or accel.build_clusters)(
        tri.v0, tri.v1, tri.v2, tri.mask, cluster_size=cluster_size)
    ids = torch.arange(samples, device=device) + FIRST_ID
    o, d = rays_for_ids(scene.camera, cfg, 0, ids)
    hits, mat, _, shades, _ = integrator._shade_hit(scene, cfg, 0, o, d, ids,
                                                    0)
    rep = lambda x: torch.repeat_interleave(x, paths, dim=0)
    path_ids = (ids[:, None] * paths
                + torch.arange(paths, device=device)[None, :]).reshape(-1)
    o1, d1, f1 = integrator._mc_continue(
        scene, cfg, 0, type(hits)(*(rep(x) for x in hits)),
        type(mat)(*(rep(x) for x in mat)), path_ids, 0)
    live = ((f1 * rep(shades)[:, None]) != 0).any(dim=1)
    B = batch_from_rays(o1.contiguous(), d1.contiguous(), live, mesh, tile_r)
    b = lab.lab_batch_from_numpy(B, device)
    if not torch.equal(b.rec, mesh.rec):
        raise RuntimeError("the lab's folded blocks are not K3's records")
    return b, mesh, B


# ---------------------------------------------------------------------------
# K3, the reference
# ---------------------------------------------------------------------------


def k3(b: lab.LabBatch, mesh):
    """K3 on the batch's sorted rays with its live mask: (t, index), on the
    card through the kernel, on the CPU through its plain version."""
    from skele_raytracer_tpu_torch.config import CLEAN
    from skele_raytracer_tpu_torch.ops.cuda import culled

    if b.feats.device.type == "cpu":
        return culled.culled_nearest_torch(b.feats, mesh.rec, b.live,
                                           sign=-1.0, clip=True)
    return culled.culled_nearest_kernel(b.feats, mesh, b.live, quirks=CLEAN)


def k3_tag(b: lab.LabBatch) -> str:
    from skele_raytracer_tpu_torch.ops.cuda import culled

    return f"nearest_kernel<{culled.lanes_for(b.feats.shape[0])}>"


def vs_k3(out, ref, live) -> str:
    """`OK` or `MISMATCH t:n idx:n` of a row's answer against K3's, over
    the live rays."""
    m = torch.ones_like(out[0], dtype=torch.bool) if live is None else live > 0
    nt = int(((out[0] != ref[0]) & m).sum())
    ni = int(((out[1] != ref[1]) & m).sum())
    return "OK" if nt == 0 and ni == 0 else f"MISMATCH t:{nt} idx:{ni}"


def p3_class(out, ref, mask=None, bound=None) -> dict:
    """A bf16x3 answer against another on the rays of `mask`: the share
    whose hit flags agree (`hits`); of the rays where both hit, the share
    with equal indices (`same`) and whether the indices agree wherever t
    agrees to P3_T_AGREE (`idx`); where both hit the same triangle, the
    largest relative and absolute t difference (`rel`, `abs`) and, with a
    per-ray `bound`, the largest difference over its bound (`over`); the
    largest difference over the largest |ref t| where both hit
    (`scaled`, for the probe's product stage)."""
    (t, i), (rt, ri) = out, ref
    if mask is not None:
        t, i, rt, ri = t[mask], i[mask], rt[mask], ri[mask]
        bound = None if bound is None else bound[mask]
    hit, rhit = t < lab.BIG, rt < lab.BIG
    both = hit & rhit
    same = both & (i == ri)
    close = both & torch.isclose(t, rt, rtol=P3_T_AGREE, atol=P3_T_AGREE)
    diff = (t - rt).abs()
    top = lambda x: float(x.max()) if x.numel() else 0.0
    res = dict(
        hits=float((hit == rhit).float().mean()) if t.numel() else 1.0,
        same=float(same.sum()) / max(int(both.sum()), 1),
        idx=bool((i[close] == ri[close]).all()),
        rel=top(diff[same] / rt.abs()[same].clamp_min(1e-30)),
        abs=top(diff[same]),
        scaled=top(diff[both]) / max(top(rt.abs()[both]), 1e-30))
    if bound is not None:
        res["over"] = top(diff[same] / bound[same].clamp_min(1e-30))
    return res


def p3_plain_ok(c: dict, stage: str = "loop") -> bool:
    """A p3 kernel's answer against its plain version's (`p3_class`)."""
    if stage == "mm":
        return c["hits"] >= P3_HITS and c["scaled"] <= P3_PLAIN_REL
    return (c["hits"] >= P3_HITS and c["same"] >= P3_SAME and c["idx"]
            and c["rel"] <= P3_PLAIN_REL)


def p3_fp32_ok(c: dict) -> bool:
    """A p3 answer against a full-FP32 one (`p3_fp32_class`)."""
    return c["hits"] >= P3_HITS and c["over"] <= 1.0 and c["unexplained"] == 0


def pair_terms(b: lab.LabBatch, rays, idx) -> dict:
    """Full-FP32 numerators of rays `rays` against the triangles of
    original index `idx` (hits), and their sums of |f_r K_r| per plane
    (`s_det`, `s_u`, `s_v`, `s_t`; s_t counts |kof|): the scale of each
    plane's bf16x3 error."""
    orig = b.aux[:, 2, :].reshape(-1).long()
    live = b.aux[:, 1, :].reshape(-1) > 0
    pos = torch.full((int(orig.max()) + 1,), -1, dtype=torch.long,
                     device=orig.device)
    pos[orig[live]] = torch.arange(orig.numel(), device=orig.device)[live]
    col = pos[idx.long()]
    c, j = col // b.cluster_size, col % b.cluster_size
    K = b.kc[c, :, :, j]  # [n, 9, 4]
    kof = b.aux[c, 0, j]
    f = b.feats[rays, :9]
    sums = lab._sums(f[:, None, :], K[:, :, :, None], 6, "kc")
    det, u, v, t = (x[:, 0, 0] for x in sums)
    s = lambda pl, r0, r1: (f[:, r0:r1].abs()
                            * K[:, r0:r1, pl].abs()).sum(1)
    return dict(det=det, u=-u, v=v, t=t - kof, s_det=s(0, 0, 3),
                s_u=s(1, 0, 6), s_v=s(2, 0, 6), s_t=s(3, 6, 9) + kof.abs())


def _t_rel(p: dict) -> torch.Tensor:
    """How far, relative to t, a bf16x3 product may move t = t_num / det
    of the pairs of `pair_terms`: (e s_t / |t_num| + e s_det / |det|) /
    (1 - e s_det / |det|) with e = P3_EPS, plus 4 ulp for the division;
    inf where det's error reaches det."""
    cd = P3_EPS * p["s_det"] / p["det"].abs()
    ct = P3_EPS * p["s_t"] / p["t"].abs()
    return torch.where(cd < 1, (ct + cd) / (1 - cd), float("inf")) + 2.0 ** -22


def p3_t_bound(b: lab.LabBatch, ref) -> torch.Tensor:
    """Per ray: how far a bf16x3 product may move the t of the full-FP32
    hit `ref` = (t, index) on the same triangle (`_t_rel` times |t|); 0
    for a miss."""
    t, idx = ref
    out = torch.zeros_like(t)
    rays = (t < lab.BIG).nonzero().flatten()
    if rays.numel():
        out[rays] = t[rays].abs() * _t_rel(pair_terms(b, rays, idx[rays]))
    return out


def decisions(b: lab.LabBatch, rays, idx) -> dict:
    """The epilogue's decisions for rays `rays` against triangles `idx` at
    full FP32, each beside the band within which the bf16x3 product may
    flip it: the barycentric margin min(u, v, 1 - u - v) (`margin`) and
    its band P3_EPS (s_u + s_v + s_det) / |det| (`band`); `near`: the
    margin, |det| against the det threshold, or t against the near clip
    lies inside its band; `t`, t_num / det, with its bound `t_bound`; and
    |det| / s_det (`cond`, 1 for a ray along the normal)."""
    from skele_raytracer_tpu_torch.config import CLEAN_T_EPS, TRIANGLE_DET_EPS

    p = pair_terms(b, rays, idx)
    det = p["det"].abs()
    sg = torch.sign(p["det"])
    margin = torch.minimum(torch.minimum(p["u"] * sg, p["v"] * sg),
                           det - (p["u"] + p["v"]) * sg) / det
    band = P3_EPS * (p["s_u"] + p["s_v"] + p["s_det"]) / det
    t = p["t"] / p["det"]
    t_bound = t.abs() * _t_rel(p)
    near = ((margin.abs() <= band)
            | ((det - TRIANGLE_DET_EPS).abs() <= P3_EPS * p["s_det"])
            | ((t - CLEAN_T_EPS).abs() <= t_bound))
    return dict(margin=margin, band=band, near=near, t=t, t_bound=t_bound,
                cond=det / p["s_det"])


def p3_flips(b: lab.LabBatch, out, ref, mask=None) -> dict:
    """The rays where a bf16x3 answer `out` and a full-FP32 `ref`
    disagree on the hit or the triangle (`rays`), with `decisions` of
    each answer's triangle (`ref_tri`, `out_tri`: one entry per ray, NaN
    where that answer misses) and `explained`: one of the two triangles'
    decisions lies inside its band, or both answers hit and the two
    triangles' full-FP32 t lie within their two bounds of each other (a
    near tie)."""
    (t, i), (rt, ri) = out, ref
    hit, rhit = t < lab.BIG, rt < lab.BIG
    bad = (hit != rhit) | (hit & rhit & (i != ri))
    if mask is not None:
        bad = bad & mask
    rays = bad.nonzero().flatten()
    explained = torch.zeros(rays.numel(), dtype=torch.bool, device=t.device)
    res = dict(rays=rays)
    for name, ii, h in (("ref_tri", ri, rhit), ("out_tri", i, hit)):
        sel = h[rays]
        full = {k: torch.full_like(t[rays], float("nan"))
                for k in ("margin", "band", "t", "t_bound", "cond")}
        full["near"] = torch.zeros_like(explained)
        if bool(sel.any()):
            d = decisions(b, rays[sel], ii[rays][sel])
            for k, v in full.items():
                v[sel] = d[k]
        res[name] = full
        explained |= full["near"]
    r, o = res["ref_tri"], res["out_tri"]
    explained |= (r["t"] - o["t"]).abs() <= r["t_bound"] + o["t_bound"]
    res["explained"] = explained
    return res


def p3_fp32_class(b: lab.LabBatch, out, ref, mask=None, bound=None) -> dict:
    """`p3_class` of a bf16x3 answer against a full-FP32 `ref`, with
    `p3_t_bound(b, ref)` as the bound, plus the rays where the hit or the
    triangle differs (`flips`) and how many of them `p3_flips` does not
    explain (`unexplained`)."""
    if bound is None:
        bound = p3_t_bound(b, ref)
    res = p3_class(out, ref, mask, bound)
    fl = p3_flips(b, out, ref, mask)
    res["flips"] = int(fl["rays"].numel())
    res["unexplained"] = int((~fl["explained"]).sum())
    return res


def flip_lines(b: lab.LabBatch, out, ref, mask=None, limit: int = 8):
    """Lines for the rays of `p3_flips`: both answers and, for each
    triangle, its margin beside its band, and |det| / s_det."""
    (t, i), (rt, ri) = out, ref
    fl = p3_flips(b, out, ref, mask)
    lines = []
    for k, r in enumerate(fl["rays"][:limit].tolist()):
        parts = [f"ray {r}: K3 t {float(rt[r]):.7g} tri {int(ri[r])}, "
                 f"p3 t {float(t[r]):.7g} tri {int(i[r])}"]
        for label, d in (("K3's", fl["ref_tri"]), ("p3's", fl["out_tri"])):
            if bool(d["margin"][k].isnan()):
                continue
            parts.append(f"{label} triangle margin {float(d['margin'][k]):.3e}"
                         f", band {float(d['band'][k]):.3e}, |det|/s_det "
                         f"{float(d['cond'][k]):.3e}")
        parts.append("inside the band" if bool(fl["explained"][k])
                     else "NOT EXPLAINED")
        lines.append("; ".join(parts))
    return lines


# ---------------------------------------------------------------------------
# Timing on the card
# ---------------------------------------------------------------------------


def slope_ms(fn, lo: int = 8, hi: int = 40, tries: int = 3) -> float:
    """Device ms per call of `fn` as the slope of `lo` against `hi`
    back-to-back calls under CUDA events (the least of `tries` each)."""
    fn()
    torch.cuda.synchronize()
    best = {}
    for k in (lo, hi):
        times = []
        for _ in range(tries):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        best[k] = min(times)
    return (best[hi] - best[lo]) / (hi - lo)


def profiler_ms(fn, tag, reps: int = 10, tries: int = 3):
    """Device ms per call of `fn`: the kernels whose names hold `tag` (one
    name, or a tuple of names each launched once per call, whose times
    are summed), from torch.profiler over `reps` calls after a warm-up
    step; a trace that lost launches is retaken, and after `tries` the
    answer is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    tags = (tag,) if isinstance(tag, str) else tuple(tag)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        per = [[e for e in cuda if t in e.key] for t in tags]
        if all(sum(e.count for e in rows) == reps for rows in per):
            us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for rows in per for e in rows)
            return us / 1e3 / reps
    return None


def device_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def cuda_ms(fn) -> float:
    """Milliseconds of one warm call of `fn` by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------


SPLIT_KERNELS = ("lab_split_init", "lab_split_unpack")


def kernel_tag(kind: str, kw: dict):
    """The profiler names of the kernels one call of a row launches: its
    kernel instance (L6's has no passes), and for the split walk (L3, L5)
    SPLIT_KERNELS too."""
    g = kw.get("group_c", 2)
    if kind == "lab_presplit":
        return f"{kind}_kernel<{g}>"
    tag = f"{kind}_kernel<{kw.get('passes', 6)}, {g}>"
    return (tag, *SPLIT_KERNELS) if kind in lab.SPLIT else tag


def differ(out, ref, live) -> tuple:
    """(live, dead) rays on which two answers differ in t or index."""
    d = (out[0] != ref[0]) | (out[1] != ref[1])
    m = torch.ones_like(d) if live is None else live > 0
    return int((d & m).sum()), int((d & ~m).sum())


def split_stats(b: lab.LabBatch, group_c: int, item_groups=None) -> dict:
    """The split walk's work items on batch b (`lab.work_items`): how many,
    and the longest, in groups; with item_groups None, lab.ITEM_GROUPS."""
    items = lab.work_items(b.counts, group_c, item_groups or lab.ITEM_GROUPS)
    return dict(items=int(items.shape[0]),
                longest=int((items[:, 2] - items[:, 1]).max())
                if items.numel() else 0)


def whole_tiles(b: lab.LabBatch, group_c: int) -> int:
    """An item length that leaves every tile one work item: the most groups
    a tile's walk can have."""
    return -(-b.n_clusters // group_c)


def evaluate(b, ref, name: str, kind: str, kw: dict, timing: bool = True,
             plain: bool = True, bound=None) -> dict:
    """One row on batch b: its answer (`lab.lab_nearest`), against K3's
    (`ref`; at passes 3 `p3_fp32_class`, with K3's `p3_t_bound` as
    `bound` when given) and, on the card with `plain`, against its plain version
    (bitwise at passes 6, `p3_plain_ok` at 3; the probe's full1 and mm
    stages too), with the plain version's time and the groups each tile
    walked; with `timing`, device ms per call (`slope_ms`,
    `profiler_ms`: the sum of the call's kernels) and the blocks an SM
    holds at once (`blocks_per_sm`). For the split walk (lab.SPLIT) on the
    card also its items (`split_stats`) and the same kernel with one item
    per tile (`whole_tiles`): the rays that differ from it, live and dead
    (`vs_tile`), and its time (`tile_ms`, `tile_dev_ms`)."""
    passes = kw.get("passes", 6)
    out = lab.lab_nearest(kind, b, **kw)
    res = dict(name=name, kind=kind, kw=kw, passes=passes, out=out,
               vs_k3=vs_k3(out, ref, b.live),
               stage=kw.get("stage", "loop") if kind == "lab_probe"
               else "loop")
    mask = None if b.live is None else b.live > 0
    if passes == 3 and res["stage"] == "loop":
        res["k3_class"] = p3_fp32_class(b, out, ref, mask, bound)
        res["k3_ok"] = p3_fp32_ok(res["k3_class"])
    cuda = b.feats.device.type == "cuda"
    if cuda and plain:
        t, i, walked = lab.lab_nearest_torch(kind, b, walked=True, **kw)
        res["walked"] = walked
        if passes == 6:
            res["plain_ok"] = (torch.equal(out[0], t)
                               and torch.equal(out[1], i))
            res["plain_err"] = float((out[0] - t).abs().max())
        else:
            cls = p3_class(out, (t, i))
            res["plain_class"] = cls
            res["plain_ok"] = p3_plain_ok(cls, res["stage"])
            res["plain_err"] = (cls["scaled"] * float(t.abs().max())
                                if res["stage"] == "mm" else cls["abs"])
        res["plain_ms"] = cuda_ms(
            lambda: lab.lab_nearest_torch(kind, b, **kw))
    if cuda and plain:
        res["vs_plain"] = differ(out, (t, i), b.live)
    split = cuda and kind in lab.SPLIT
    if split:
        g = kw.get("group_c", 2)
        res.update(split_stats(b, g))
        tile_kw = dict(kw, item_groups=whole_tiles(b, g))
        res["vs_tile"] = differ(out, lab.lab_nearest_kernel(kind, b,
                                                            **tile_kw),
                                b.live)
    if cuda and timing:
        fn = lambda: lab.lab_nearest_kernel(kind, b, **kw)
        res["ms"] = slope_ms(fn)
        res["dev_ms"] = profiler_ms(fn, kernel_tag(kind, kw))
        res["blocks_per_sm"] = lab.blocks_per_sm(
            kind, kw.get("group_c", 2), passes, b.cluster_size)
        if split:
            fn = lambda: lab.lab_nearest_kernel(kind, b, **tile_kw)
            res["tile_ms"] = slope_ms(fn)
            res["tile_dev_ms"] = profiler_ms(fn, kernel_tag(kind, kw))
    return res


def format_row(res: dict) -> str:
    """A row's line: times, the answer against K3 and its plain version."""
    parts = [f"{res['name']:26s}"]
    ms = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    if "ms" in res:
        parts.append(f"{res['ms']:8.4f} ms device per call (slope 8 vs 40), "
                     f"profiler {ms(res['dev_ms'])} (all kernels), "
                     f"{res['blocks_per_sm']} blocks/SM")
    if "items" in res:
        parts.append(f"split walk: {res['items']} items of at most "
                     f"{lab.ITEM_GROUPS} groups (longest {res['longest']})")
    if "tile_ms" in res:
        parts.append(f"one item per tile {res['tile_ms']:.4f} ms (slope), "
                     f"profiler {ms(res['tile_dev_ms'])}")
    if "vs_tile" in res:
        parts.append(f"vs one item per tile: {res['vs_tile'][0]} live, "
                     f"{res['vs_tile'][1]} dead rays differ")
    parts.append(f"[{res['vs_k3']}]")
    if res["stage"] != "loop":
        parts.append("(wrong on purpose, timing only)")
    if "k3_class" in res:
        c = res["k3_class"]
        parts.append(f"p3 vs K3 {'in class' if res['k3_ok'] else 'OUT'}: "
                     f"hits {c['hits']:.4%}, same triangle {c['same']:.4%}, "
                     f"indices {'equal' if c['idx'] else 'DIFFER'} where t "
                     f"agrees, {c['flips']} rays on another hit "
                     f"({c['unexplained']} outside the bf16x3 band), on the "
                     f"same triangle max rel t diff {c['rel']:.3e} and max "
                     f"diff / bf16x3 bound {c['over']:.3f}")
    if "plain_ok" in res:
        c = res.get("plain_class")
        kind = ("bitwise" if c is None else
                f"hits {c['hits']:.4%}, max diff {c['scaled']:.3e} of the "
                f"largest value" if res["stage"] == "mm" else
                f"hits {c['hits']:.4%}, same triangle {c['same']:.4%}, max "
                f"rel t diff {c['rel']:.3e}")
        parts.append(f"vs plain: {'ok' if res['plain_ok'] else 'FAIL'} "
                     f"({kind}; {res['vs_plain'][0]} live, "
                     f"{res['vs_plain'][1]} dead rays differ; plain "
                     f"{res['plain_ms']:.2f} ms)")
    return " ".join(parts)


def worst_pair(b: lab.LabBatch, out, ref, mask=None) -> str:
    """The ray whose bf16x3 t lies furthest, relative to t, from the
    full-FP32 t on the same triangle, with its conditioning: |det| /
    s_det and |t_num| / s_t (`pair_terms`)."""
    (t, i), (rt, ri) = out, ref
    same = (t < lab.BIG) & (rt < lab.BIG) & (i == ri)
    if mask is not None:
        same = same & mask
    if not bool(same.any()):
        return "no ray hits the same triangle"
    rel = torch.where(same, (t - rt).abs() / rt.abs().clamp_min(1e-30), -1.0)
    r = int(rel.argmax())
    p = pair_terms(b, torch.tensor([r], device=t.device), ri[r].reshape(1))
    return (f"largest rel t diff on the same triangle: ray {r}, "
            f"{float(rel[r]):.3e}; |det|/s_det "
            f"{float(p['det'].abs() / p['s_det']):.3e}, |t_num|/s_t "
            f"{float(p['t'].abs() / p['s_t']):.3e}")


def k3_row(b, mesh, label: str, timing: bool):
    """K3's answer on the batch, and its row's line."""
    ref = k3(b, mesh)
    line = f"{label:26s}"
    if timing:
        fn = lambda: k3(b, mesh)
        dev = profiler_ms(fn, k3_tag(b))
        line += (f" {slope_ms(fn):8.4f} ms device (slope 8 vs 40), profiler "
                 + ("not measured" if dev is None else f"{dev:.4f} ms"))
    return ref, line + " [ref]"


def run_rows(rows: dict, names, device: str, samples: int, ref_label: str,
             extra=None):
    """Builds the batch on `device` and prints K3's row and each named row
    of `rows` (all when `names` is empty); `extra(res)` may print more
    after a row. Returns the rows' results."""
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("the lab runs on the card: no CUDA device is "
                         "visible (--device cpu runs the plain versions)")
    unknown = [n for n in names if n not in rows]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {list(rows)}")
    b, mesh, _ = build_batch(device=device, samples=samples)
    timing = b.feats.device.type == "cuda"
    head = device_line() if timing else "the CPU (plain versions)"
    print(f"[lab] {b.feats.shape[0]} bounce rays "
          f"({float(b.live.mean()):.3f} live), {b.n_tiles} tiles, "
          f"{b.n_clusters} clusters of {b.cluster_size}, mean shortlist "
          f"{float(b.counts.float().mean()):.2f} clusters, on {head}")
    ref, line = k3_row(b, mesh, ref_label, timing)
    print(line)
    bound, shown = p3_t_bound(b, ref), False
    out = []
    for name in names or list(rows):
        kind, kw = rows[name]
        res = evaluate(b, ref, name, kind, kw, timing=timing, bound=bound)
        print(format_row(res))
        if "k3_class" in res and not shown:
            for text in ([worst_pair(b, res["out"], ref, b.live > 0)]
                         + flip_lines(b, res["out"], ref, b.live > 0)):
                print(f"  {name} vs K3: {text}")
            shown = True
        if extra is not None:
            extra(res, b)
        out.append(res)
    return out


# the split walk's rows that `items_sweep` times at each item length
SWEEP_ROWS = ("lab_base", "lab_3pass", "flat_g2", "flat_g2_3p", "flat_g4_3p")


def items_sweep(b: lab.LabBatch, emit=print, names=SWEEP_ROWS,
                lengths=(1, 2, 3, 4)):
    """The split walk's rows `names` on the card at each item length of
    `lengths` (groups per item) and at one item per tile (`whole_tiles`):
    each one's items, the longest, and its device ms per call (profiler,
    summed over the call's kernels, and the slope); each line goes to
    `emit`."""
    for name in names:
        kind, kw = ROWS[name]
        g = kw.get("group_c", 2)
        for L in (*lengths, whole_tiles(b, g)):
            fn = lambda: lab.lab_nearest_kernel(kind, b, item_groups=L, **kw)
            st = split_stats(b, g, L)
            dev = profiler_ms(fn, kernel_tag(kind, kw))
            emit(f"{name} at {L} groups per item: {st['items']} items, the "
                 f"longest {st['longest']}; "
                 + ("not measured" if dev is None else f"{dev:.4f} ms")
                 + f" per call (profiler, all kernels), {slope_ms(fn):.4f} "
                 f"ms (slope)")


def cs_sweep(device: str = "cuda", samples: int = 8192, emit=print):
    """K3 at cluster sizes 256, 128 and 64 in tiles of 256 and 128 rays
    (the shortlist's mean length per tile), its answers unsorted into the
    rays' own order and held against the first clustering's; each line
    goes to `emit`. Returns whether every clustering agreed."""
    ref, same = None, True
    timing = torch.device(device).type == "cuda"
    for csz, tr in ((256, 256), (128, 256), (64, 256), (128, 128),
                    (64, 128)):
        b, mesh, B = build_batch(csz, tr, device=device, samples=samples)
        emit(f"cs={csz} tile_r={tr}: clusters={b.n_clusters} mean tile "
             f"count {float(b.counts.float().mean()):.2f}")
        # K3 needs no tiles: its answer on the sorted rays, unsorted
        t, idx = k3(b, mesh)
        inv = torch.as_tensor(B["ray_order"], device=t.device)
        t_o, i_o = torch.empty_like(t), torch.empty_like(idx)
        t_o[inv], i_o[inv] = t, idx
        if ref is None:
            ref, ok = (t_o, i_o), "ref"
        else:
            nt = int((t_o != ref[0]).sum())
            ni = int((i_o != ref[1]).sum())
            ok = "OK" if nt == ni == 0 else f"MISMATCH t:{nt} idx:{ni}"
            same = same and ok == "OK"
        line = f"  cs={csz} tr={tr} K3"
        if timing:
            fn = lambda: k3(b, mesh)
            line += f" {slope_ms(fn):8.4f} ms device (slope 8 vs 40)"
        emit(f"{line}  [{ok}]")
    return same


def parse(argv, description):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, timed) or cpu (the plain "
                         "versions)")
    ap.add_argument("--samples", type=int, default=8192,
                    help="samples of the batch, 16 bounce rays each (a "
                         "multiple of 16)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv, __doc__.split("\n\n")[0])
    if args.rows[:1] == ["cs-sweep"]:
        return 0 if cs_sweep(args.device, args.samples) else 1
    if args.rows[:1] == ["items-sweep"]:
        if args.device == "cpu" or not torch.cuda.is_available():
            raise SystemExit("items-sweep times the kernels: it runs on the "
                             "card")
        items_sweep(build_batch(device=args.device,
                                samples=args.samples)[0])
        return 0
    run_rows(ROWS, args.rows, args.device, args.samples, "prod (K3)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

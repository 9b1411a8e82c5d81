"""Frozen work counts and the H100's peaks: the least time the card could
take for a kernel's job, from the scene's tables and the sample count.

A copy of `roofline`, `k1_sample_work`, `k1_work` and `k2_work` as the
program's utils/roofline.py held them when this benchmark was written,
kept here so that a later change to the program cannot move its own
yardstick. The counts describe the job (per sample: the camera ray, the
threefry draws, a test of every table row, shading, the bounces), not one
kernel's code, so any kernel that does the same job reads against the
same bound. `static_args` derives the counts' inputs from the reference's
own reading of the scene (`perfbench/reference/scene.py`), with the
tables laid out as the counts were written for: sphere and triangle rows
padded to a multiple of 8, light and fog rows to at least one.
"""

from __future__ import annotations

import numpy as np

# Peak rates of one H100 SXM at 700 W: FP32 and HBM from NVIDIA's data
# sheet; the SFU (sqrt, reciprocal, exp, log, sin, cos) at 16 per SM per
# clock x 132 SMs x 1.98 GHz; INT32 at 64 lanes per SM x 132 SMs x 1.98
# GHz (the SM diagram of NVIDIA's Hopper architecture white paper). The
# last two rest on an assumed 1.98 GHz boost clock.
FP32_PEAK = 67e12
BF16_TC_PEAK = 989e12
INT32_PEAK = 64 * 132 * 1.98e9
SFU_PEAK = 16 * 132 * 1.98e9
HBM_PEAK = 3.35e12


def roofline(fp32=0.0, sfu=0.0, int32=0.0, nbytes=0.0, mma=0.0):
    """(bound_ms, bound_by): the larger of the operations' time, each type
    at its peak, and the bytes' time at HBM's rate."""
    ops_s = max(fp32 / FP32_PEAK, sfu / SFU_PEAK, int32 / INT32_PEAK,
                mma / BF16_TC_PEAK)
    mem_s = nbytes / HBM_PEAK
    return max(ops_s, mem_s) * 1e3, ("operations" if ops_s >= mem_s
                                     else "bytes")


def _w(f=0, s=0, i=0):
    return np.array([f, s, i], np.float64)  # fp32, sfu, int32 operations


def static_args(scene, cfg) -> dict:
    """The counts' inputs from a reference scene and config: table rows,
    lights, fog volumes, which blocks are live, and the integrator."""
    def rows(group, key, multiple=1):
        n = max(group[key].shape[0] if group else 0, 1)
        return -(-n // multiple) * multiple

    point_on = bool(scene.point_lights) and not scene.fog_zeroed
    return dict(
        S=rows(scene.spheres, "center", 8),
        T=rows(scene.triangles, "v0", 8) if scene.triangles else 1,
        L=rows(scene.point_lights, "position"),
        LD=rows(scene.directional_lights, "direction"),
        sph_on=bool(scene.spheres), tri_on=bool(scene.triangles),
        point_on=point_on, dir_on=bool(scene.directional_lights),
        use_shadows=cfg.shadows, mc=cfg.gillum > 0, P=cfg.paths,
        D=cfg.depth, grid=cfg.jsample, parity=cfg.parity,
        F=0 if scene.fog_zeroed else rows(scene.fog, "center"))


def k1_sample_work(st, replay=False):
    """Operations of one sample of the whole-frame path trace (or, with
    replay, of one replay forward of its gradient): [fp32, sfu, int32].
    Scans count every table row: a (ray, sphere) test ~20 FP32 operations
    and a square root, ~13 from the camera's staged rows (the primary
    scan), a (ray, triangle) test ~40 and a division. A shading point's
    shadow scans, one per light, count each sphere row's o - c and c (~8)
    and its test (~13), and each triangle row's origin half (~17) and the
    rest (~25), for every light, whole. Rows that no lane of a warp can
    hit skip their square root: not counted. The replay has no scans."""
    S, T = st["S"] * st["sph_on"], st["T"] * st["tri_on"]
    norm_dirs = not st["parity"]
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
        T_sh = 0 if st["parity"] else T
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


def k1_work(st, n, records=False):
    """(bound_ms, bound_by) of the whole-frame path trace over n samples:
    the operations above, and per sample 20 B of planes in and 12 B of
    radiance out (4 B per hit record with `records`), plus the tables."""
    f, sfu, i = k1_sample_work(st) * n
    tables = 4 * (st["S"] * 16 + st["T"] * 24 + (1 + st["F"]) * 24
                  + (st["L"] + st["LD"]) * 8)
    K = 1 + (st["P"] * (st["D"] - 1) if st["mc"] and st["D"] > 1 else 0)
    nbytes = n * (20 + 12 + (4 * K if records else 0)) + tables
    return roofline(f, sfu, i, nbytes)


def k2_work(st, n):
    """(bound_ms, bound_by) of the path trace's gradient over n samples:
    per sample the replay forward, the recompute of each path's earlier
    bounces (D(D-1)/2 per path) and an adjoint of about twice the
    replay's operations, plus the warp reductions (a staged row per
    record, a shuffle tree per light and misc value)."""
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

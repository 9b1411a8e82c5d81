"""The kernel lab's nearest-hit kernels L1-L6 (csrc/culled_lab.cu): the
batch they take, their plain PyTorch versions and the CUDA kernels'
wrappers.

The counterparts of the JAX package's TPU lab kernels, which no render path
launches (skele_raytracer_tpu_torch/tools/ times them):

* L1 `lab_v6`: tools/lab_v5.py `_v6_kernel` (`launch_v6`);
* L2 `lab_v5`: tools/lab_v5.py `_v5_kernel` (`launch_v5`);
* L3 `lab_base`: tools/kernel_lab.py `_lab_kernel` (`launch_lab`);
* L4 `lab_probe`: tools/lab_probe.py `_probe_kernel` (`launch_probe`);
* L5 `lab_flat`: tools/kernel_lab.py `_flat_kernel` (`launch_flat`);
* L6 `lab_presplit`: tools/kernel_lab.py `_presplit_kernel`
  (`launch_presplit`), bf16x3 only.

Each takes a `LabBatch`: a bounce wave's feature rows [R, 10] ([d, o x d,
o, 1]) sorted by footprint into tiles of TILE_R rays, each tile's cluster
shortlist front to back (`order` [T, C], `counts` [T], the sorted tile
entries `ent` [T, C + 1], BIG after the last), the cluster boxes (`lo`,
`hi`: their union is the root box of the settle bound) and the per-cluster
constants, unfolded (`kc` [C, 9, 4, cs], `aux` [C, 3, cs]: kof, mask,
original index; L3, L4), folded (`k10` [C, 10, 4, cs], `org` [C, 1, cs];
L1, L2; `fold`), unfolded and zero-padded to 16 rows (`kcf` [C, 16,
4 cs], plane-major as the TPU's flat blocks, with `aux`; L5; `flatten`) or
unfolded and split into bf16 hi and lo (`khl` [C, 9, 4, cs, 2] bfloat16:
hi and lo of a value side by side, one 32-bit word, with `aux`; L6;
`presplit`). The host tables are built once per batch, as the TPU
launchers build theirs outside the kernel. It returns (t [R], original
index [R] int32): the nearest hit over the tile's shortlist, walked group_c clusters
at a time until the next group's entry lies past the tile's settle bound
(the largest min(best t, root exit) of its rays); an exact-t tie goes to
the lower index; a miss is (BIG, BIG_I). The answer is that of every ray of
the tile, dead or alive: the shortlist is built from the live rays only.

The switches, per kernel (SWITCHES; defaults those of the TPU launchers):
L1 `per_group`, L2 `split_path`, L3 `gate_settle`, `thin_epilogue`,
`no_early_exit`, L4 `stage` ("loop", "full1": one unconditional group, "mm":
the product and a cheap minimum; both wrong on purpose, timing only); L5
and L6 take none and settle after every group (L3 with gate_settle off);
for all `group_c` (GROUPS) and `passes` (6: full FP32; 3: bf16x3, the
product on tensor cores in the kernel; L6 3 only). No switch but `stage`
changes an output bit.

The plain versions (`lab_nearest_torch`) follow the kernels' control path
with every tile's group at once, from the same host tables as the
kernels. At passes = 6 they sum each numerator in csrc/mesh_math.cuh's
order (the record order of `culled.planes_torch`), so their answer is
bitwise K3's plain version's (`culled.culled_nearest_torch` on
`LabBatch.rec`) wherever the walk's culls are exact; L5's reads rows 0-8
of its padded blocks. At passes = 3 they split features and constants
into bf16 hi + lo and sum each product over the plane's rows in order,
then hh + (hl + lh) (lo.lo dropped, as `culled._plane_dot` in the JAX
package); L5's sums all 16 rows of its blocks against the features
padded with zeros (the zero rows add exact zeros), L6's takes hi and lo
from `khl`; so both answer as L3's. The kernel's tensor cores accumulate
in their own order, so it matches to a tolerance.
With `groups=(p0, p1)` they walk only groups p0 .. p1 - 1 of every
tile, from no hit, with the settle test from that range's own bests: the
answer of one work item of the split walk below.

`lab_nearest_kernel` launches csrc/culled_lab.cu on CUDA tensors and
raises on anything else; `lab_nearest` picks by the batch's device. L1,
L2, L4 and L6 walk a tile per block. L3 and L5 (SPLIT) take the split
walk: each tile's groups cut into work items of at most `item_groups`
groups (`work_items`: every tile's full items, then the shorter last
ones), taken by a persistent grid, each ray's best merged exactly by a
64-bit atomicMin of (t bits, index); three kernels per call
(KERNELS_PER_CALL). For live rays the answer is the whole walk's (the
settle test is conservative); a dead ray's equals it wherever the whole
walk does not stop early.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from skele_raytracer_tpu_torch.config import CLEAN_T_EPS, TRIANGLE_DET_EPS
from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda._build import check_outputs
from skele_raytracer_tpu_torch.ops.cuda.culled import BIG_I, _culled_t
from skele_raytracer_tpu_torch.ops.cuda.intersect import BIG, PLAIN_BLOCK
from skele_raytracer_tpu_torch.scene.types import _Tensors

TILE_R = 256  # rays per tile: one block (tools/kernel_lab.py TILE_R)
GROUPS = (1, 2, 4)  # clusters per group the kernels are built for
KERNELS = ("lab_v6", "lab_v5", "lab_base", "lab_probe", "lab_flat",
           "lab_presplit")
STAGES = ("loop", "full1", "mm")
FOLDED = ("lab_v6", "lab_v5")  # the kernels that take k10 / org
# each kernel's cluster blocks (csrc/culled_lab.cu Layout)
LAYOUT = {"lab_v6": "folded", "lab_v5": "folded", "lab_base": "kc",
          "lab_probe": "kc", "lab_flat": "flat", "lab_presplit": "presplit"}
FLAT_ROWS = 16  # rows of L5's padded blocks (tools/kernel_lab.py kcf)
# rows of each kernel's blocks and of its aux table (csrc/culled_lab.cu
# rows_of, aux_rows_of)
ROWS = {"lab_v6": (10, 1), "lab_v5": (10, 1), "lab_base": (9, 3),
        "lab_probe": (9, 3), "lab_flat": (FLAT_ROWS, 3),
        "lab_presplit": (9, 3)}
SWITCHES = {"lab_v6": ("per_group",), "lab_v5": ("split_path",),
            "lab_base": ("gate_settle", "thin_epilogue", "no_early_exit"),
            "lab_probe": ("stage",), "lab_flat": (), "lab_presplit": ()}
DEFAULTS = dict(per_group=False, split_path=True, gate_settle=True,
                thin_epilogue=False, no_early_exit=False, stage="full1")
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90
PAD = 4  # floats after each staged row of 4 cs (csrc/culled_lab.cu kPad)

# The kernels that take the split walk, its groups per work item by
# default, and the CUDA kernels one wrapper call launches
SPLIT = ("lab_base", "lab_flat")
ITEM_GROUPS = 2
KERNELS_PER_CALL = {k: 3 if k in SPLIT else 1 for k in KERNELS}

# Calls of each kernel's wrapper that launched it, counted where the
# wrapper launches it (KERNELS_PER_CALL kernels each).
LAUNCHES = {k: 0 for k in KERNELS}


@dataclass
class LabBatch(_Tensors):
    """A lab batch on one device (module docstring). `rec` [C, cs, 20]
    holds the same triangles as K3's records; `live` [R] (sorted) where the
    batch has it."""

    feats: torch.Tensor
    order: torch.Tensor
    counts: torch.Tensor
    ent: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    kc: torch.Tensor
    aux: torch.Tensor
    k10: torch.Tensor
    org: torch.Tensor
    kcf: torch.Tensor
    khl: torch.Tensor
    rec: torch.Tensor
    live: Optional[torch.Tensor] = None

    @property
    def n_tiles(self) -> int:
        return self.order.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.kc.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.kc.shape[3]


def fold(kc, aux):
    """(k10 [C, 10, 4, cs], org [C, 1, cs]) from kc [C, 9, 4, cs] and aux
    [C, 3, cs], NumPy: tools/lab_v5.py `launch_v6`'s fold (row 9 of the t
    column carries -kof; every column times mask > 0)."""
    kc = np.asarray(kc, np.float32)
    aux = np.asarray(aux, np.float32)
    C, _, _, cs = kc.shape
    k10 = np.zeros((C, 10, 4, cs), np.float32)
    k10[:, 0:9] = kc
    k10[:, 9, 3, :] = -aux[:, 0, :]
    k10 *= aux[:, 1:2, None, :] > 0
    return k10, np.ascontiguousarray(aux[:, 2:3, :])


def flatten(kc):
    """kcf [C, 16, 4 cs] from kc [C, 9, 4, cs], NumPy: tools/kernel_lab.py
    `launch_flat`'s plane-major blocks (columns det | u | v | t, cs each),
    rows 9-15 zero."""
    kc = np.asarray(kc, np.float32)
    C, rows, planes, cs = kc.shape
    kcf = np.zeros((C, FLAT_ROWS, planes * cs), np.float32)
    kcf[:, :rows] = kc.reshape(C, rows, planes * cs)
    return kcf


def presplit(kc):
    """khl [C, 9, 4, cs, 2] bfloat16 from kc: tools/kernel_lab.py
    `launch_presplit`'s split, hi = bf16(kc) and lo = bf16(kc - hi), both
    rounded to nearest even, side by side (csrc/lab_math.cuh
    `presplit_word`)."""
    kc = torch.as_tensor(np.asarray(kc, np.float32))
    hi = kc.to(torch.bfloat16)
    lo = (kc - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, lo], dim=-1).contiguous()


def lab_tables(v0, v1, v2, mask, perm, cluster_size: int):
    """(kc [C, 9, 4, cs], aux [C, 3, cs]), NumPy, of Morton-sorted padded
    triangles (a ClusteredMesh's v0, v1, v2, mask, perm): the JAX
    package's `pack_triangles` layout, as tools/kernel_lab.py builds it
    (rows d 0:3, w 3:6, o 6:9; planes det, u_num, v_num, t_num), with the
    NumPy expressions of accel.build_clusters, so that `fold` of them is
    bitwise the records of the same mesh."""
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a)).astype(np.float32)
    sv0, sv1, sv2, m, perm = (as_np(a) for a in (v0, v1, v2, mask, perm))
    e1 = (sv1 - sv0).astype(np.float32)
    e2 = (sv2 - sv0).astype(np.float32)
    Am = np.cross(e2, e1)
    Bm = np.cross(e2, sv0)
    Cm = np.cross(sv0, e1)
    Dm = np.cross(e1, e2)
    kof = np.sum(e2 * Cm, axis=1)
    T = sv0.shape[0]
    C = T // cluster_size
    K = np.zeros((9, 4, T), np.float32)
    K[0:3, 0] = Am.T
    K[0:3, 1] = Bm.T
    K[3:6, 1] = -e2.T
    K[0:3, 2] = -Cm.T
    K[3:6, 2] = -e1.T
    K[6:9, 3] = Dm.T
    kc = np.ascontiguousarray(
        K.reshape(9, 4, C, cluster_size).transpose(2, 0, 1, 3))
    aux = np.stack([kof.reshape(C, cluster_size), m.reshape(C, cluster_size),
                    perm.reshape(C, cluster_size)], axis=1)
    return kc, aux.astype(np.float32)


def lab_batch_from_numpy(B: dict, device="cpu") -> LabBatch:
    """The port's operands of a JAX lab batch (tools/kernel_lab.py
    `build_batch`'s dict, as NumPy arrays: feats [R, 9], order, counts,
    ent, lo, hi, kc, aux; optionally live [R], in sorted order): the
    features with the constant 1 column, the folded blocks of `launch_v6`,
    the padded blocks of `launch_flat`, the split of `launch_presplit`
    and K3's records of the same triangles."""
    feats = np.asarray(B["feats"], np.float32)
    R = feats.shape[0]
    kc = np.asarray(B["kc"], np.float32)
    aux = np.asarray(B["aux"], np.float32)
    k10, org = fold(kc, aux)
    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=device)
    return LabBatch(
        feats=t(np.concatenate([feats, np.ones((R, 1), np.float32)], 1)),
        order=t(B["order"], torch.int32), counts=t(B["counts"], torch.int32),
        ent=t(B["ent"]), lo=t(B["lo"]), hi=t(B["hi"]), kc=t(kc), aux=t(aux),
        k10=t(k10), org=t(org), kcf=t(flatten(kc)),
        khl=presplit(kc).to(device),
        rec=t(accel.records_from_k10(k10, org)),
        live=None if B.get("live") is None else t(B["live"]))


def _flags(kind: str, switches: dict) -> dict:
    """The kernel-level switches (csrc/culled_lab.cu LabArgs) of a call."""
    if kind not in KERNELS:
        raise ValueError(f"lab kernel: one of {KERNELS}, got {kind!r}")
    bad = set(switches) - set(SWITCHES[kind])
    if bad:
        raise TypeError(f"{kind} takes the switches {SWITCHES[kind]}, got "
                        f"{sorted(bad)}")
    sw = {**DEFAULTS, **switches}
    if sw["stage"] not in STAGES:
        raise ValueError(f"stage: one of {STAGES}, got {sw['stage']!r}")
    return dict(
        thin=kind == "lab_base" and bool(sw["thin_epilogue"]),
        gate=kind == "lab_base" and bool(sw["gate_settle"]),
        no_exit=kind == "lab_base" and bool(sw["no_early_exit"]),
        split=kind == "lab_v6" or (kind == "lab_v5" and bool(sw["split_path"])),
        per_group=kind == "lab_v6" and bool(sw["per_group"]),
        stage=sw["stage"] if kind == "lab_probe" else "loop")


def _check_shape(kind: str, group_c: int, passes: int):
    if group_c not in GROUPS:
        raise ValueError(f"group_c: one of {GROUPS}, got {group_c}")
    allowed = (3,) if kind == "lab_presplit" else (3, 6)
    if passes not in allowed:
        raise ValueError(f"{kind} passes: one of {allowed}, got {passes}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _split(x):
    """bf16 hi and lo of x (round to nearest even), as float32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _plane_sum(f, K, plane, r0, r1):
    """[Tn, TILE_R, W]: sum over rows r0..r1-1 of f[..., r] K[:, r, plane],
    left to right from the first term."""
    s = None
    for r in range(r0, r1):
        term = f[:, :, r:r + 1] * K[:, None, r, plane, :]
        s = term if s is None else s + term
    return s


def _plane(f, K, plane, r0, r1, passes, layout):
    if passes == 6:
        return _plane_sum(f, K, plane, r0, r1)
    fh, fl = _split(f)
    if layout == "presplit":  # K: the hi rows, then the lo rows
        rows = K.shape[1] // 2
        kh, kl = K[:, :rows], K[:, rows:]
    else:
        kh, kl = _split(K)
    return (_plane_sum(fh, kh, plane, r0, r1)
            + (_plane_sum(fh, kl, plane, r0, r1)
               + _plane_sum(fl, kh, plane, r0, r1)))


def _thin_t(det, u, v, t):
    """csrc/lab_math.cuh `thin_t`: the sign-bit tests."""
    ok = torch.abs(det) >= TRIANGLE_DET_EPS
    w = det - (u + v)
    bd = det.view(torch.int32)
    agree = lambda x: ((x.view(torch.int32) ^ bd) >= 0) | (x == 0)
    valid = ok & agree(u) & agree(v) & agree(w)
    t = t / torch.where(ok, det, 1.0)
    return torch.where(valid & (t > CLEAN_T_EPS), t, BIG)


def _sums(f, K, passes, layout):
    """The four plane sums of rays f [Tn, TILE_R, 10] against columns K
    [Tn, rows, 4, W] of a `layout` ("kc", "folded", "flat", "presplit": hi
    rows then lo rows): det over rows 0:3, u and v over 0:6, t over 6:9 and
    row 9 when folded; the flat blocks at passes 3 over all 16 rows, the
    features padded with zeros (the tensor cores' contraction). Each
    [Tn, TILE_R, W]."""
    if layout == "flat" and passes == 3:
        f = torch.nn.functional.pad(f, (0, FLAT_ROWS - f.shape[-1]))
        return tuple(_plane(f, K, p, 0, FLAT_ROWS, passes, layout)
                     for p in range(4))
    return (_plane(f, K, 0, 0, 3, passes, layout),
            _plane(f, K, 1, 0, 6, passes, layout),
            _plane(f, K, 2, 0, 6, passes, layout),
            _plane(f, K, 3, 6, 10 if layout == "folded" else 9, passes,
                   layout))


def _pair_t(sums, A, *, folded, thin, stage):
    """Each pair's t (BIG where it misses) from its plane sums and the
    columns' aux rows A [Tn, aux rows, W] (csrc/lab_math.cuh `planes3`,
    `pair_t`); at the probe's "mm" stage, det + t_num before kof."""
    det, u, v, t_num = sums
    if stage == "mm":
        return det + t_num
    u = -u
    if not folded:
        t_num = t_num - A[:, None, 0, :]
    t_all = _thin_t(det, u, v, t_num) if thin else _culled_t(
        det, u, v, t_num, clip=True)
    if not folded:
        t_all = torch.where(A[:, None, 1, :] > 0, t_all, BIG)
    return t_all


def _group(f, K, A, t_cur, i_cur, *, passes, layout, thin, stage):
    """One step of the walk for a set of tiles: f [Tn, TILE_R, 10], K
    [Tn, rows, 4, W] and A [Tn, aux rows, W] the step's columns; returns
    the updated (t, index) [Tn, TILE_R]."""
    folded = layout == "folded"
    t_all = _pair_t(_sums(f, K, passes, layout), A, folded=folded,
                    thin=thin, stage=stage)
    if stage == "mm":  # the product and a cheap minimum
        return torch.minimum(t_cur, t_all.amin(-1)), i_cur
    orig = A[:, 0] if folded else A[:, 2]
    t_blk = t_all.amin(-1)
    o_blk = torch.where(t_all == t_blk[..., None], orig[:, None, :],
                        float(BIG_I)).amin(-1).to(torch.int32)
    better = (t_blk < t_cur) | ((t_blk < BIG) & (t_blk == t_cur)
                                & (o_blk < i_cur))
    return torch.where(better, t_blk, t_cur), torch.where(better, o_blk,
                                                          i_cur)


def _root_exit(f, root_lo, root_hi):
    """[..]: each ray's exit from the root box (csrc/lab_math.cuh
    `root_exit`)."""
    te = None
    for a in range(3):
        d = f[..., a]
        inv = 1.0 / torch.where(d.abs() > 1e-30, d, 1e-30)
        m = torch.maximum((root_lo[a] - f[..., 6 + a]) * inv,
                          (root_hi[a] - f[..., 6 + a]) * inv)
        te = m if te is None else torch.minimum(te, m)
    return te


def _plain_tables(kind: str, b: LabBatch):
    """(K [C, rows, 4, cs] float32, A [C, aux rows, cs]) the plain version
    of `kind` reads: the kernel's own host tables (L6: the hi rows, then
    the lo rows, widened from bfloat16)."""
    if kind in FOLDED:
        return b.k10, b.org
    if kind == "lab_flat":
        return b.kcf.reshape(b.n_clusters, FLAT_ROWS, 4, -1), b.aux
    if kind == "lab_presplit":
        return torch.cat([b.khl[..., 0], b.khl[..., 1]], 1).float(), b.aux
    return b.kc, b.aux


def lab_nearest_torch(kind: str, b: LabBatch, *, group_c: int = 2,
                      passes: int = 6, walked: bool = False,
                      groups: Optional[tuple] = None, **switches):
    """Plain version of lab kernel `kind` on batch b: (t [R], index [R]
    int32), and with `walked` also the groups each tile walked [T] (int64).
    With `groups` = (p0, p1), only groups p0 .. p1 - 1 of each tile's walk
    (module docstring). Runs on b's device."""
    fl = _flags(kind, switches)
    _check_shape(kind, group_c, passes)
    layout = LAYOUT[kind]
    K, A = _plain_tables(kind, b)
    T, C, cs, G = b.n_tiles, b.n_clusters, b.cluster_size, group_c
    dev = b.feats.device
    f = b.feats.reshape(T, TILE_R, -1)
    texit = _root_exit(f, b.lo.amin(0), b.hi.amax(0))
    t = torch.full((T, TILE_R), BIG, dtype=torch.float32, device=dev)
    idx = torch.full((T, TILE_R), BIG_I, dtype=torch.int32, device=dev)
    n = b.counts.long()
    loop = fl["stage"] == "loop"
    once = (n <= G) & fl["split"] if loop else torch.ones_like(n, dtype=bool)
    n_groups = torch.where(once, ((n > 0) | (not loop)).long(), -(-n // G))
    p0, p1 = groups if groups is not None else (0, None)
    settles = ~once & (loop and not fl["no_exit"])
    done = torch.zeros(T, dtype=torch.bool, device=dev)
    steps = torch.zeros(T, dtype=torch.int64, device=dev)
    W = G * cs
    chunk = max(1, PLAIN_BLOCK[dev.type] // (TILE_R * W))
    parts = [slice(g * cs, (g + 1) * cs) for g in range(G)] if fl[
        "per_group"] else [slice(0, W)]
    top = int(n_groups.max()) if T else 0
    for p in range(p0, top if p1 is None else min(p1, top)):
        act = ((p < n_groups) & ~done).nonzero().flatten()
        if act.numel() == 0:
            break
        steps[act] += 1
        cols = torch.clamp(p * G + torch.arange(G, device=dev), max=C - 1)
        for s in range(0, act.numel(), chunk):
            tl = act[s:s + chunk]
            ci = b.order[tl][:, cols].long()  # [Tn, G]
            Kg = K[ci].permute(0, 2, 3, 1, 4).reshape(tl.numel(), -1, 4, W)
            Ag = A[ci].permute(0, 2, 1, 3).reshape(tl.numel(), -1, W)
            t_c, i_c = t[tl], idx[tl]
            for part in parts:
                t_c, i_c = _group(f[tl], Kg[..., part], Ag[..., part], t_c,
                                  i_c, passes=passes, layout=layout,
                                  thin=fl["thin"], stage=fl["stage"])
            t[tl], idx[tl] = t_c, i_c
        sl = act[settles[act]]
        if fl["gate"]:
            sl = sl[p + 1 < n_groups[sl]]
        if sl.numel():
            settle = torch.minimum(t[sl], texit[sl]).amax(1)
            nxt = min((p + 1) * G, C)
            done[sl] = done[sl] | (b.ent[sl, nxt] > settle)
    out = (t.reshape(-1), idx.reshape(-1))
    return (*out, steps) if walked else out


def work_items(counts, group_c: int, item_groups: int) -> torch.Tensor:
    """The split walk's work items [N, 3] int64 (tile, p0, p1: groups p0 ..
    p1 - 1 of the tile's walk) of shortlists `counts` [T] at group_c
    clusters per group and at most `item_groups` groups per item, in the
    kernel's order (csrc/lab_math.cuh `item_at`): every tile's full items
    of item_groups groups, in tile order, then each tile's shorter last
    item."""
    if item_groups < 1:
        raise ValueError(f"item_groups: at least 1, got {item_groups}")
    g = -(-counts.long() // group_c)
    full, rest = g // item_groups, g % item_groups
    tiles = torch.arange(g.numel(), device=g.device)
    ft = tiles.repeat_interleave(full)
    start = torch.cumsum(full, 0) - full
    k = torch.arange(ft.numel(), device=g.device) - start[ft]
    rt = tiles[rest > 0]
    p0 = torch.cat([k * item_groups, g[rt] - rest[rt]])
    p1 = torch.cat([(k + 1) * item_groups, g[rt]])
    return torch.stack([torch.cat([ft, rt]), p0, p1], 1)


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_lib = None


def bind(lib):
    """Declares `culled_lab` of a loaded library."""
    lib.culled_lab.argtypes = ([ctypes.c_int] * 14 + [ctypes.c_float]
                               + [ctypes.c_void_p] * 12)
    lib.culled_lab.restype = ctypes.c_int
    lib.culled_lab_workspace.argtypes = [ctypes.c_int]
    lib.culled_lab_workspace.restype = ctypes.c_longlong
    lib.culled_lab_occupancy.argtypes = [ctypes.c_int] * 4
    lib.culled_lab_occupancy.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (if needed) and load the lab's CUDA library."""
    global _lib
    if _lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        _lib = bind(load_cuda("culled_lab"))
    return _lib


def stages(kind: str, group_c: int) -> int:
    """Stages of a launch's ring (csrc/culled_lab.cu `stages_of`): two, but
    one for L5 at G 4, whose two stages of 16-row blocks would not fit."""
    return 1 if kind == "lab_flat" and group_c == 4 else 2


def launch_shape(kind: str, group_c: int, cs: int) -> int:
    """Dynamic shared-memory bytes of a launch (`stages` of group_c staged
    clusters, each row padded by PAD floats), as csrc/culled_lab.cu
    `smem_bytes` computes them. Raises ValueError for a group size or
    cluster size the kernels do not take and for a block that would not
    fit."""
    if group_c not in GROUPS:
        raise ValueError(f"group_c: one of {GROUPS}, got {group_c}")
    if cs % 8:
        raise ValueError(f"cluster size: a multiple of 8, got {cs}")
    rows, aux_rows = ROWS[kind]
    smem = (stages(kind, group_c) * 4 * group_c
            * (rows * (4 * cs + PAD) + aux_rows * cs))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{group_c} clusters of {cs} triangles need {smem} "
                         f"bytes of shared memory per block, more than "
                         f"{SMEM_LIMIT}")
    return smem


def blocks_per_sm(kind: str, group_c: int, passes: int, cs: int) -> int:
    """Blocks of kernel `kind` one SM of the current card holds at once at
    this launch shape (its registers and `launch_shape`'s shared memory);
    for SPLIT kernels also the blocks of their persistent grid per SM."""
    _check_shape(kind, group_c, passes)
    launch_shape(kind, group_c, cs)
    n = build_kernel().culled_lab_occupancy(KERNELS.index(kind), passes,
                                            group_c, cs)
    if n < 0:
        raise RuntimeError(f"{kind} occupancy query failed: CUDA error {-n}")
    return n


def lab_nearest_kernel(kind: str, b: LabBatch, *, group_c: int = 2,
                       passes: int = 6, item_groups: Optional[int] = None,
                       sm_blocks: int = 0, **switches):
    """Lab kernel `kind` on CUDA tensors: (t, index) as
    `lab_nearest_torch`; counted in LAUNCHES[kind]. SPLIT kernels cut the
    walk into items of at most `item_groups` groups (ITEM_GROUPS by
    default) and run as many blocks per SM as fit, or at most `sm_blocks`
    (> 0); other values than the defaults are for measurement and tests."""
    fl = _flags(kind, switches)
    _check_shape(kind, group_c, passes)
    if item_groups is None:
        item_groups = ITEM_GROUPS
    if kind in SPLIT and item_groups < 1:
        raise ValueError(f"item_groups: at least 1, got {item_groups}")
    dev = b.feats.device
    if dev.type != "cuda":
        raise ValueError(f"{kind} kernel: CUDA tensors, got {dev}")
    T, C, cs = b.n_tiles, b.n_clusters, b.cluster_size
    R = T * TILE_R
    rows, aux_rows = ROWS[kind]
    K_shape, K_dtype = (C, rows, 4, cs), torch.float32
    if kind == "lab_flat":
        K, A, K_shape = b.kcf, b.aux, (C, rows, 4 * cs)
    elif kind == "lab_presplit":
        K, A = b.khl, b.aux
        K_shape, K_dtype = (C, rows, 4, cs, 2), torch.bfloat16
    else:
        K, A = (b.k10, b.org) if kind in FOLDED else (b.kc, b.aux)
    want = ((b.feats, (R, 10), torch.float32), (b.order, (T, C), torch.int32),
            (b.counts, (T,), torch.int32), (b.ent, (T, C + 1), torch.float32),
            (b.lo, (C, 3), torch.float32), (b.hi, (C, 3), torch.float32),
            (K, K_shape, K_dtype), (A, (C, aux_rows, cs), torch.float32))
    for x, shape, dtype in want:
        if (x.device != dev or x.dtype != dtype or not x.is_contiguous()
                or tuple(x.shape) != shape):
            raise ValueError(f"{kind} kernel: a contiguous {dtype} {shape} "
                             f"operand on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if K.data_ptr() % 16 or A.data_ptr() % 16:
        raise ValueError(f"{kind} kernel: cluster blocks must be 16-byte "
                         f"aligned")
    launch_shape(kind, group_c, cs)
    lib = build_kernel()
    t = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    work = (torch.empty(lib.culled_lab_workspace(T), dtype=torch.uint8,
                        device=dev) if kind in SPLIT else None)
    args = (KERNELS.index(kind), passes, group_c, T, C, cs, int(fl["thin"]),
            int(fl["gate"]), int(fl["no_exit"]), int(fl["split"]),
            int(fl["per_group"]), STAGES.index(fl["stage"]), item_groups,
            sm_blocks, CLEAN_T_EPS,
            *(x.data_ptr() for x in (b.feats, b.order, b.counts, b.ent, b.lo,
                                     b.hi, K, A, t, idx)),
            None if work is None else work.data_ptr())
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.culled_lab(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err}")
    LAUNCHES[kind] += 1
    check_outputs(kind, t, idx)
    return t, idx


def lab_nearest(kind: str, b: LabBatch, **kw):
    """Lab kernel `kind` on b: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if b.feats.device.type == "cpu":
        return lab_nearest_torch(kind, b, **kw)
    return lab_nearest_kernel(kind, b, **kw)

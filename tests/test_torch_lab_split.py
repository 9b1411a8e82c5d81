"""The split walk of the kernel lab's L3 `lab_base` and L5 `lab_flat`
(csrc/culled_lab.cu `lab_items`): a tile's walk cut into work items of a
few groups each, walked by many blocks, and each ray's best merged by a
64-bit key (csrc/lab_math.cuh `best_key`, `min_key`, `item_at`).

Batches: tests/test_torch_lab.py's synthetic `lab_case` (512 rays in 2
tiles of 256, a seeded 200-triangle mesh in 4 clusters of 64, 30% dead
rays sorted last; no settle exit fires on it), made here from the same
seeds so that the file imports no JAX and its `cuda` test runs on the
card, and a stack of 16 parallel
quads in clusters of 8 triangles, on which the settle exit stops every
tile's walk early (`stack`).

All bitwise:
* the g++ build of the key helpers (lab_math_host.cpp) against torch's
  lexicographic (t, index) minimum, on exact-t ties, misses and a tile
  whose shortlist is empty;
* the plain version walked over group ranges (one range per work item)
  and merged by the host build's keys, against the whole plain walk: on
  the live rays for every switch, on every ray with no_early_exit (the
  settle test is conservative for the live rays only), at group_c 1, 2
  and 4, both layouts and both products;
* the host build's work items against `lab.work_items`: each tile's
  groups covered once, no item longer than its bound.
The CUDA kernels against their plain versions: the `cuda` test, which
skips without a GPU (on the card: `python -m pytest --noconftest -o
addopts= tests/test_torch_lab_split.py -q`; chip_smoke.py `[lab]` runs
the full batch).
"""

import ctypes

import numpy as np
import pytest
import torch

from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import _build, lab
from skele_raytracer_tpu_torch.tools import kernel_lab

P = ctypes.c_void_p
BIG, BIG_I = lab.BIG, lab.BIG_I
ITEMS = (1, 2)  # item lengths the merge is built from, in groups
# (kernel, switches) of the L3 and L5 rows' families
SWITCHES = [("lab_base", dict(gate_settle=False)),
            ("lab_base", dict(gate_settle=True)),
            ("lab_base", dict(gate_settle=True, thin_epilogue=True)),
            ("lab_base", dict(gate_settle=False, thin_epilogue=True)),
            ("lab_base", dict(gate_settle=False, no_early_exit=True)),
            ("lab_flat", {})]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host():
    lib = _build.build_host("lab_math", ["lab_math_host.cpp"])
    lib.lab_keys_host.argtypes = [ctypes.c_int, P, P, P]
    lib.lab_keys_host.restype = None
    lib.lab_key_min_host.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, P]
    lib.lab_key_min_host.restype = None
    lib.lab_items_host.argtypes = [ctypes.c_int, P, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, P]
    lib.lab_items_host.restype = ctypes.c_int
    return lib


def _lab_case_arrays():
    """tests/test_torch_lab.py's `lab_case` inputs: test_torch_accel's
    `random_mesh(t=200, seed=11)`, its `_rays(512, 12)` and the live mask
    of seed 13."""
    rng = np.random.default_rng(11)
    v0 = rng.uniform(-8.0, 8.0, (200, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(200, 3)).astype(np.float32)
    v2 = v0 + rng.normal(size=(200, 3)).astype(np.float32)
    m = np.ones((200,), np.float32)
    m[-5:] = 0.0
    rng = np.random.default_rng(12)
    o = rng.normal(size=(512, 3))
    o = (16.0 * o / np.linalg.norm(o, axis=1, keepdims=True))
    d = rng.uniform(-7.0, 7.0, (512, 3)) - o
    live = np.random.default_rng(13).uniform(size=512) > 0.3
    return (v0, v1, v2, m), (o.astype(np.float32), d.astype(np.float32)), live


@pytest.fixture(scope="module")
def lab_case():
    (v0, v1, v2, m), (o, d), live = _lab_case_arrays()
    mesh = accel.build_clusters(*(torch.from_numpy(a) for a in
                                  (v0, v1, v2, m)), cluster_size=64)
    B = kernel_lab.batch_from_rays(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(live), mesh)
    return lab.lab_batch_from_numpy(B)


def test_lab_case_is_test_torch_lab_s():
    pytest.importorskip("jax")
    from tests.test_torch_accel import random_mesh
    from tests.test_torch_lab import _rays

    mesh, rays, live = _lab_case_arrays()
    for a, b in zip(mesh + rays, random_mesh(t=200, seed=11) + _rays(512, 12)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        live, np.random.default_rng(13).uniform(size=512) > 0.3)


@pytest.fixture(scope="module")
def stack():
    """A lab batch whose settle exit fires: 16 unit quads (2 triangles
    each) at z = 0 .. 15 in clusters of 8 triangles, and 512 rays from
    z = -5 along +z (30% dead) that all meet the first quad."""
    rng = np.random.default_rng(21)
    v0, v1, v2 = [], [], []
    for z in range(16):
        a, b_, c, d = ([-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z])
        v0 += [a, a]
        v1 += [b_, c]
        v2 += [c, d]
    v0, v1, v2 = (np.asarray(x, np.float32) for x in (v0, v1, v2))
    mesh = accel.build_clusters(*(torch.from_numpy(x) for x in
                                  (v0, v1, v2, np.ones(32, np.float32))),
                                cluster_size=8)
    xy = rng.uniform(-0.9, 0.9, (512, 2))
    o = np.concatenate([xy, np.full((512, 1), -5.0)], 1).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.02, 0.02, (512, 2)),
                        np.ones((512, 1))], 1).astype(np.float32)
    live = torch.from_numpy(rng.uniform(size=512) > 0.3)
    B = kernel_lab.batch_from_rays(torch.from_numpy(o), torch.from_numpy(d),
                                   live, mesh)
    return lab.lab_batch_from_numpy(B)


def _batch(name, lab_case, stack):
    return lab_case if name == "lab_case" else stack


def _lexmin(ts, idxs):
    """torch's lexicographic minimum of (t, index) over the first axis."""
    t = ts.amin(0)
    i = torch.where(ts == t, idxs, torch.iinfo(torch.int32).max).amin(0)
    return t, i.to(torch.int32)


def _host_merge(host, ts, idxs):
    """The host build's merge (lab_key_min_host) of answers [m, n]."""
    ts, idxs = ts.contiguous(), idxs.contiguous()
    m, n = ts.shape
    out_t = torch.empty(n, dtype=torch.float32)
    out_i = torch.empty(n, dtype=torch.int32)
    host.lab_key_min_host(n, m, ts.data_ptr(), idxs.data_ptr(),
                          out_t.data_ptr(), out_i.data_ptr())
    return out_t, out_i


def test_keys_order_as_the_pairs(host):
    rng = np.random.default_rng(5)
    t = rng.choice(np.float32([1e-4, 0.5, 1.0, 2.0, 7.25, 3.0e38]), 4096)
    t = np.where(rng.uniform(size=4096) < 0.5, t,
                 rng.uniform(1e-4, 1e3, 4096)).astype(np.float32)
    idx = rng.integers(0, 1 << 30, 4096).astype(np.int32)
    miss = t == np.float32(BIG)
    idx[miss] = BIG_I
    keys = np.empty(4096, np.uint64)
    host.lab_keys_host(4096, t.ctypes.data, idx.ctypes.data, keys.ctypes.data)
    want = (t.view(np.uint32).astype(np.uint64) << np.uint64(32)) | idx.view(
        np.uint32).astype(np.uint64)
    np.testing.assert_array_equal(keys, want)
    # sorting by key sorts by (t, index); the miss is the largest key
    assert np.array_equal(np.argsort(keys, kind="stable"),
                          np.lexsort((idx, t)))
    assert miss.any() and bool((keys[miss] == keys.max()).all())


def test_key_min_is_the_lexicographic_min(host):
    rng = np.random.default_rng(6)
    m, n = 5, 2048
    t = rng.choice(np.float32([0.25, 1.0, 1.5, BIG]), (m, n))
    idx = rng.integers(0, 1000, (m, n)).astype(np.int32)
    idx[t == np.float32(BIG)] = BIG_I
    # rays whose every answer is a miss, and rays tied on t in every answer
    t[:, :64], idx[:, :64] = BIG, BIG_I
    t[:, 64:128] = 1.0
    ts, idxs = torch.from_numpy(t), torch.from_numpy(idx)
    got = _host_merge(host, ts, idxs)
    want = _lexmin(ts, idxs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0][:64] == BIG).all() and (got[1][:64] == BIG_I).all())
    assert torch.equal(got[1][64:128], idxs[:, 64:128].amin(0))


@pytest.mark.parametrize("batch", ["lab_case", "stack"])
def test_merge_of_plain_answers_with_an_empty_tile(host, lab_case, stack,
                                                   batch):
    b = _batch(batch, lab_case, stack)
    b = lab.LabBatch(**{**b.__dict__, "counts": b.counts.clone()})
    b.counts[0] = 0  # the first tile enters no cluster: all misses
    whole = lab.lab_nearest_torch("lab_base", b)
    parts = [lab.lab_nearest_torch("lab_base", b, groups=(p, p + 1))
             for p in range(-(-int(b.counts.max()) // 2))]
    ts = torch.stack([p[0] for p in parts])
    idxs = torch.stack([p[1] for p in parts])
    got = _host_merge(host, ts, idxs)
    want = _lexmin(ts, idxs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    live = b.live > 0
    assert torch.equal(got[0][live], whole[0][live])
    assert torch.equal(got[1][live], whole[1][live])
    assert bool((got[0][:lab.TILE_R] == BIG).all())
    assert bool((got[1][:lab.TILE_R] == BIG_I).all())


@pytest.mark.parametrize("batch", ["lab_case", "stack"])
@pytest.mark.parametrize("passes", [6, 3])
@pytest.mark.parametrize("group_c", lab.GROUPS)
@pytest.mark.parametrize("case", SWITCHES, ids=[
    f"{k}-" + "-".join(s for s, v in kw.items() if v) for k, kw in SWITCHES])
def test_group_ranges_merge_to_the_whole_walk(host, lab_case, stack,
                                              batch, passes, group_c, case):
    kind, sw = case
    b = _batch(batch, lab_case, stack)
    kw = dict(group_c=group_c, passes=passes, **sw)
    whole = lab.lab_nearest_torch(kind, b, **kw)
    n_groups = -(-int(b.counts.max()) // group_c)
    live = b.live > 0
    for L in ITEMS:
        parts = [lab.lab_nearest_torch(kind, b, groups=(p, p + L), **kw)
                 for p in range(0, n_groups, L)]
        got = _host_merge(host, torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] for p in parts]))
        rays = (torch.ones_like(live) if sw.get("no_early_exit") else live)
        assert torch.equal(got[0][rays], whole[0][rays]), (L, kw)
        assert torch.equal(got[1][rays], whole[1][rays]), (L, kw)


@pytest.mark.parametrize("batch", ["lab_case", "stack"])
@pytest.mark.parametrize("group_c", lab.GROUPS)
def test_group_ranges_walk_their_groups(lab_case, stack, batch, group_c):
    b = _batch(batch, lab_case, stack)
    groups = -(-b.counts.long() // group_c)
    for L in ITEMS:
        for p in range(0, int(groups.max()), L):
            _, _, walked = lab.lab_nearest_torch(
                "lab_base", b, group_c=group_c, walked=True,
                groups=(p, p + L), no_early_exit=True)
            assert torch.equal(walked, (groups - p).clamp(0, L)), (L, p)


def test_the_stack_batch_stops_early(stack):
    _, _, walked = lab.lab_nearest_torch("lab_base", stack, group_c=1,
                                         walked=True)
    assert bool((walked < stack.counts.long()).all())


@pytest.mark.parametrize("group_c", lab.GROUPS)
@pytest.mark.parametrize("item_groups", [1, 2, 3, 4, 64])
def test_items_cover_every_group_once(host, group_c, item_groups):
    rng = np.random.default_rng(group_c * 100 + item_groups)
    counts = rng.integers(0, 80, 300).astype(np.int32)
    counts[:20] = 0
    counts[20] = 79
    cap = 300 * 80
    out = np.zeros((cap, 3), np.int32)
    n = host.lab_items_host(300, counts.ctypes.data, group_c, item_groups,
                            cap, out.ctypes.data)
    items = lab.work_items(torch.from_numpy(counts), group_c, item_groups)
    assert n == items.shape[0]
    np.testing.assert_array_equal(out[:n], items.numpy())
    tile, p0, p1 = items.unbind(1)
    assert bool((p1 > p0).all()) and bool((p1 - p0 <= item_groups).all())
    # the full items first, the shorter ones after
    length = p1 - p0
    short = (length < item_groups).nonzero()
    if short.numel():
        assert bool((length[:int(short[0])] == item_groups).all())
    groups = -(-torch.from_numpy(counts).long() // group_c)
    cover = torch.zeros(300, int(groups.max()), dtype=torch.int64)
    for t, a, z in items.tolist():
        cover[t, a:z] += 1
    want = torch.arange(cover.shape[1])[None, :] < groups[:, None]
    assert torch.equal(cover, want.long())


def test_items_of_the_lab_batch_shapes(lab_case):
    b = lab_case
    stats = kernel_lab.split_stats(b, 1, 1)
    assert stats == dict(items=int(b.counts.sum()), longest=1)
    assert kernel_lab.whole_tiles(b, 2) == 2
    assert kernel_lab.split_stats(b, 2, kernel_lab.whole_tiles(b, 2)) == dict(
        items=b.n_tiles, longest=2)


def test_the_wrapper_refuses_an_empty_item(lab_case):
    b = lab_case
    with pytest.raises(ValueError, match="item_groups"):
        lab.lab_nearest_kernel("lab_base", b, item_groups=0)
    with pytest.raises(ValueError, match="item_groups"):
        lab.work_items(b.counts, 2, 0)
    assert lab.KERNELS_PER_CALL == {k: 3 if k in ("lab_base", "lab_flat")
                                    else 1 for k in lab.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["lab_case", "stack"])
def test_split_kernels_match_plain_on_the_card(lab_case, stack, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    b = _batch(batch, lab_case, stack)
    bc = b.to("cuda")
    live = b.live > 0
    for kind, sw in SWITCHES:
        for group_c in lab.GROUPS:
            for passes in (6, 3):
                kw = dict(group_c=group_c, passes=passes, **sw)
                want = lab.lab_nearest_torch(kind, b, **kw)
                whole = kernel_lab.whole_tiles(b, group_c)
                tile = lab.lab_nearest_kernel(kind, bc, item_groups=whole,
                                              **kw)
                for L, sm in ((1, 0), (2, 0), (2, 1), (whole, 0)):
                    before = lab.LAUNCHES[kind]
                    got = lab.lab_nearest_kernel(kind, bc, item_groups=L,
                                                 sm_blocks=sm, **kw)
                    assert lab.LAUNCHES[kind] == before + 1
                    got = tuple(x.cpu() for x in got)
                    # the items' merge is exact: the live rays' answers do
                    # not depend on the item length
                    assert torch.equal(got[0][live], tile[0].cpu()[live])
                    assert torch.equal(got[1][live], tile[1].cpu()[live])
                    if passes == 6:
                        assert torch.equal(got[0][live], want[0][live])
                        assert torch.equal(got[1][live], want[1][live])
                    else:
                        cls = kernel_lab.p3_class(got, want, live)
                        assert kernel_lab.p3_plain_ok(cls), (kind, kw, cls)

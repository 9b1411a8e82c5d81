"""The kernel lab's L5 `lab_flat` and L6 `lab_presplit` (ops/cuda/lab.py,
csrc/culled_lab.cu) against the JAX package's tools/kernel_lab.py
`launch_flat` and `launch_presplit`, which run here in TPU interpret mode,
and against the port's own L3 `lab_base`, whose walk both share.

Batches: tests/test_torch_lab.py's synthetic 512-ray batch (a seeded
200-triangle mesh in 4 clusters of 64, 30% dead rays) and its 4,096-ray
dragon bounce wave (`kernel_lab.build_batch(device="cpu", samples=256)`).

Tolerances:
* p6 (full FP32) against the JAX kernel: hit flags and indices equal on
  every ray, t within 1e-6 relative: the TPU sums the 16-deep padded
  contraction at HIGHEST precision in XLA's order, the port the 19 nonzero
  terms in csrc/mesh_math.cuh's order (which keeps it bitwise K3's), so
  t may differ by an ulp or two;
* p3 (bf16x3) against the JAX kernel: `kernel_lab.p3_plain_ok`, the class
  the card holds a p3 kernel to against its plain version;
* bitwise: the plain L5 against the plain L3 at p6 and p3 (L5's padding
  adds exact zeros), the plain L6 against the plain L3 p3 (the host split
  is the split L3 makes), the host tables against the TPU launchers'
  relayout and split, and the g++ build of the fragment functions L6
  adds to csrc/lab_math.cuh against L3's split and pack.
The CUDA kernels are held against their plain versions, K3 and L3 on the
card (chip_smoke.py `[lab]`; here the `cuda` test skips), and with them L4
`lab_probe`'s one-group stream (its full1 and mm stages;
tests/test_torch_lab_split.py `check_stream_on_the_card`, which that file's
JAX-free card test runs too) against its plain version.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from skele_raytracer_tpu_torch.ops.cuda import _build, lab
from skele_raytracer_tpu_torch.tools import kernel_lab
from skele_raytracer_tpu_torch.utils import roofline
from tests.test_torch_lab import DRAGON_SAMPLES, j_kl, lab_case  # noqa: F401
from tests.test_torch_lab_split import check_stream_on_the_card

P = ctypes.c_void_p
BIG = lab.BIG


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions' many small ops slow down
    by two orders of magnitude when every xdist worker spins 8 threads on
    a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dragon():
    b, _, _ = kernel_lab.build_batch(device="cpu", samples=DRAGON_SAMPLES)
    return b


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# (kernel, arguments, the JAX tool's launcher and its arguments)
JAX_CASES = [
    ("lab_flat", dict(group_c=2, passes=6), j_kl.launch_flat,
     dict(group_c=2, passes=6)),
    ("lab_flat", dict(group_c=2, passes=3), j_kl.launch_flat,
     dict(group_c=2, passes=3)),
    ("lab_flat", dict(group_c=4, passes=3), j_kl.launch_flat,
     dict(group_c=4, passes=3)),
    ("lab_presplit", dict(group_c=2, passes=3), j_kl.launch_presplit,
     dict(group_c=2)),
]


@pytest.mark.parametrize("case", JAX_CASES, ids=[
    f"{c[0]}-g{c[1]['group_c']}-p{c[1]['passes']}" for c in JAX_CASES])
def test_plain_matches_jax_tool(lab_case, case):
    _, Bj, b, _ = lab_case
    kind, kw, launch, jkw = case
    with pltpu.force_tpu_interpret_mode():
        jt, jidx = launch(Bj, **jkw)()
    ref = (torch.from_numpy(np.array(jt)), torch.from_numpy(np.array(jidx)))
    out = lab.lab_nearest(kind, b, **kw)
    assert out[0].shape == (512,) and out[1].dtype == torch.int32
    assert int((out[0] < BIG).sum()) > 50  # the batch has hits to compare
    if kw["passes"] == 6:
        hit = ref[0] < BIG
        assert torch.equal(out[0] < BIG, hit)
        assert torch.equal(out[1], ref[1])
        rel = ((out[0] - ref[0]).abs() / ref[0].abs())[hit]
        assert float(rel.max()) <= 1e-6
    else:
        cls = kernel_lab.p3_class(out, ref)
        assert kernel_lab.p3_plain_ok(cls), cls


@pytest.mark.parametrize("group_c", lab.GROUPS)
def test_plain_flat_and_presplit_are_bitwise_plain_l3(dragon, group_c):
    b = dragon
    for passes in (6, 3):
        base = lab.lab_nearest("lab_base", b, group_c=group_c, passes=passes,
                               gate_settle=False)
        assert _equal(lab.lab_nearest("lab_flat", b, group_c=group_c,
                                      passes=passes), base), passes
    assert _equal(lab.lab_nearest("lab_presplit", b, group_c=group_c,
                                  passes=3),
                  lab.lab_nearest("lab_base", b, group_c=group_c, passes=3,
                                  gate_settle=False))


def test_flat_g4_answers_as_g2_on_the_live_rays(dragon):
    # the walk merges by (t, index), so the group size changes no live
    # ray's answer; dead rays may differ: a G 4 group can reach clusters
    # past the live rays' shortlist
    b = dragon
    g2 = lab.lab_nearest("lab_flat", b, group_c=2, passes=3)
    g4 = lab.lab_nearest("lab_flat", b, group_c=4, passes=3)
    live = b.live > 0
    assert torch.equal(g2[0][live], g4[0][live])
    assert torch.equal(g2[1][live], g4[1][live])


def test_host_tables_are_the_tpu_launchers(lab_case):
    B, Bj, b, _ = lab_case
    C, cs = B["C"], B["cs"]
    # tools/kernel_lab.py launch_flat :571-575
    kcf = Bj["kc"].reshape(C, 9, 4, cs)
    kcf = jnp.concatenate([kcf[:, :, p, :] for p in range(4)], axis=2)
    kcf = jnp.concatenate([kcf, jnp.zeros((C, 7, 4 * cs), kcf.dtype)],
                          axis=1)
    assert b.kcf.shape == (C, 16, 4 * cs)
    np.testing.assert_array_equal(b.kcf.numpy(), np.asarray(kcf))
    # launch_presplit :696-698, read back as float32 from the words
    kh = Bj["kc"].astype(jnp.bfloat16)
    kl = (Bj["kc"] - kh.astype(jnp.float32)).astype(jnp.bfloat16)
    assert b.khl.shape == (C, 9, 4, cs, 2) and b.khl.dtype == torch.bfloat16
    for got, want in ((b.khl[..., 0], kh), (b.khl[..., 1], kl)):
        np.testing.assert_array_equal(
            got.float().numpy().view(np.int32),
            np.asarray(want.astype(jnp.float32)).view(np.int32))
    assert int((b.khl[..., 1] != 0).sum()) > 1000  # the lo halves are used


def test_presplit_fragments_are_l3s_bitwise(lab_case):
    # L6's B-fragment registers (lab::hi_pair, lo_pair of the host words)
    # against L3's (lab::split, lab::pack2) on every pair of the batch's
    # constants and on values of every magnitude
    _, _, b, _ = lab_case
    lib = _build.build_host("lab_math", ["lab_math_host.cpp"])
    fn = lib.lab_fragments_host
    fn.argtypes = [ctypes.c_int] + [P] * 7
    fn.restype = None
    rng = np.random.default_rng(7)
    x = torch.cat([b.kc.flatten(), torch.from_numpy(
        (rng.normal(size=8192) * 10.0 ** rng.integers(-30, 30, 8192))
        .astype(np.float32))])
    x0, x1 = x[0::2].contiguous(), x[1::2].contiguous()
    n = x0.numel()
    out = [torch.empty(n, dtype=torch.int32) for _ in range(5)]
    fn(n, x0.data_ptr(), x1.data_ptr(), *(o.data_ptr() for o in out))
    bh3, bl3, bh6, bl6, words = out
    assert torch.equal(bh3, bh6) and torch.equal(bl3, bl6)
    # the host table's words are lab::presplit_word's
    assert torch.equal(words, lab.presplit(x0.numpy()).view(torch.int32)
                       .flatten())


def test_launch_shape_of_the_new_kernels():
    # L5 at G 4 stages one group: two stages of 16-row blocks would not fit
    one = lab.launch_shape("lab_flat", 4, 128)
    assert one == 4 * 4 * (16 * (4 * 128 + 4) + 3 * 128) == 138_240
    assert 2 * one > lab.SMEM_LIMIT
    assert lab.launch_shape("lab_flat", 2, 128) == 2 * 4 * 2 * (
        16 * (4 * 128 + 4) + 3 * 128)
    assert lab.launch_shape("lab_presplit", 2, 128) == lab.launch_shape(
        "lab_base", 2, 128)
    with pytest.raises(ValueError, match="shared memory"):
        lab.launch_shape("lab_flat", 4, 256)
    with pytest.raises(ValueError, match="passes"):
        lab.lab_nearest_torch("lab_presplit", None, passes=6)
    with pytest.raises(TypeError, match="switches"):
        lab.lab_nearest_torch("lab_flat", None, gate_settle=False)


def test_lab_work_of_the_new_kernels(lab_case):
    # L5 counts L3's operations and reads its 16-row blocks; L6 drops the
    # split of the constants and reads the bytes of one float32 block
    _, _, b, _ = lab_case
    _, _, walked = lab.lab_nearest_torch("lab_base", b, walked=True)
    T, C, cs = b.n_tiles, b.n_clusters, b.cluster_size
    kw = dict(passes=3, group_c=2)
    base = roofline.lab_work(b, walked, kind="lab_base", **kw)
    flat = roofline.lab_work(b, walked, kind="lab_flat", **kw)
    split = roofline.lab_work(b, walked, kind="lab_presplit", **kw)
    columns = float(walked.sum()) * 2 * cs
    pairs = columns * lab.TILE_R
    head = T * 256 * 48 + T * (2 * C + 2) * 4 + C * 24
    mma = pairs * 3 * 4 * 2 * 9
    fp32 = pairs * roofline.LAB_EPILOGUE
    assert base == roofline.roofline(fp32 + columns * 9 * 4 * 3, pairs, 0,
                                     head + C * (9 * 4 + 3) * cs * 4, mma)
    assert flat == roofline.roofline(fp32 + columns * 9 * 4 * 3, pairs, 0,
                                     head + C * (16 * 4 + 3) * cs * 4, mma)
    assert split == roofline.roofline(fp32, pairs, 0,
                                      head + C * (9 * 4 + 3) * cs * 4, mma)
    assert roofline.lab_work(b, walked, kind="lab_flat", passes=6,
                             group_c=2)[0] >= roofline.lab_work(
        b, walked, kind="lab_base", passes=6, group_c=2)[0]


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card(lab_case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _, _, b, _ = lab_case
    bc = b.to("cuda")
    base = {p: lab.lab_nearest("lab_base", bc, passes=p, gate_settle=False)
            for p in (6, 3)}
    for kind, kw in (("lab_flat", dict(passes=6)),
                     ("lab_flat", dict(passes=3)),
                     ("lab_flat", dict(passes=3, group_c=4)),
                     ("lab_presplit", dict(passes=3))):
        got = lab.lab_nearest(kind, bc, **kw)
        want = lab.lab_nearest_torch(kind, b, **kw)
        if kw["passes"] == 6:
            assert _equal(tuple(x.cpu() for x in got), want)
        else:
            cls = kernel_lab.p3_class(tuple(x.cpu() for x in got), want)
            assert kernel_lab.p3_plain_ok(cls), (kind, kw, cls)
        if kw.get("group_c", 2) == 2:  # the same fragments as L3's
            assert _equal(got, base[kw["passes"]]), (kind, kw)
    check_stream_on_the_card(b, bc)  # L4's full1 and mm

"""The gradient side of the port's whole-frame path tracer
(ops/cuda/pathtrace.py): the forward's hit records, the plain version of
the backward kernel K2 (autograd of the record-driven replay), the g++
host build of the hand-written adjoint (csrc/frame_adjoint.cuh) and the
independent replay oracle `_replay_radiance`.

Tolerances:
* records: bitwise, against the JAX package's kernel in Pallas interpret
  mode and against the host build of K1's records variant;
* host adjoint (on the kernel's schedule, csrc/frame_math_host.cpp) vs
  autograd of the plain replay: per table, |host - plain| <= 1e-4 *
  max|plain| + 1e-6 (the same float32 math in another order);
* the oracle's radiance vs the records' forward: rtol 1e-4, atol 1e-5
  (tests/test_pathtrace.py's test_replay_value_matches_kernel);
* fixed-topology finite differences of the sphere centres: relative
  error below 1e-2 (tests/test_pathtrace.py's FD check).
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import KERNEL_CASES, case_scene_and_config
from skele_raytracer_tpu.config import CLEAN as J_CLEAN
from skele_raytracer_tpu.config import RenderConfig as JConfig
from skele_raytracer_tpu.ops.pallas import pathtrace as j_pt
from skele_raytracer_tpu.scene.parser import parse_scene_text as j_parse_text
from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
from skele_raytracer_tpu_torch.ops.cuda import _build
from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)
from skele_raytracer_tpu_torch.scene.parser import parse_scene_text
from tests.conftest import TEST_SCN_FOG
from tests.test_pathtrace import SPHERES_SCN

SPHERES1 = open(__file__.rsplit("/", 2)[0] + "/scenes/spheres1.scn").read()


def _port(jscene):
    return scene_from_numpy(*scene_to_numpy(jscene))


def _planes(scene, cfg, n, seed=0):
    return (pt._pack_tables(scene), pt._plane_inputs(cfg, torch.arange(n)),
            pt._static_kernel_args(scene, cfg))


# (scene text, mode, paths, depth): the records cases, spheres1 parity and
# clean and the fog scene clean at depth 2 and 3. The JAX kernel in
# interpret mode takes 30-150 s of CPU per case, so half of them run from
# tests/test_torch_records_jax.py, a file the test runner can schedule
# beside this one.
RECORD_CASES = [("spheres1", "parity", 2, 3), ("spheres1", "clean", 2, 2),
                ("fog", "clean", 2, 2)]


def record_case_id(case):
    return "{}-{}-p{}d{}".format(*case)


@pytest.mark.parametrize("case", RECORD_CASES,
                         ids=[record_case_id(c) for c in RECORD_CASES])
def test_records_match_jax_kernel_interpreted(case):
    check_records_match_jax(case)


def check_records_match_jax(case):
    """frame_math_torch's records on an 8x6 frame bitwise equal to the JAX
    kernel's (`_pathtrace_call(with_records=True)`, interpret mode)."""
    src, mode, paths, depth = case
    text = SPHERES1 if src == "spheres1" else TEST_SCN_FOG
    jq = J_CLEAN if mode == "clean" else JConfig().quirks
    kw = dict(width=8, height=6, monte_carlo=True, num_paths=paths,
              max_depth=depth, use_shadows=True)
    jcfg = JConfig(quirks=jq, backend="pallas", **kw)
    tcfg = RenderConfig(quirks=CLEAN if mode == "clean" else
                        RenderConfig().quirks, backend="torch", **kw)
    jscene = j_parse_text(text).to_scene(jq)
    assert j_pt._can_replay(jscene, jcfg)
    ids = np.arange(48, dtype=np.uint32)
    _, j_rec = j_pt._pathtrace_call(jscene, jcfg, jnp.uint32(5),
                                    jnp.asarray(ids), with_records=True)
    tscene = _port(jscene)
    assert pt._can_replay(tscene, tcfg)
    tabs, planes, static = _planes(tscene, tcfg, 48)
    *_, rec = pt.frame_math_torch(tabs, planes, 5, emit_records=True,
                                  **static)
    assert rec.dtype == torch.int32
    assert rec.shape == (pt._n_records(tcfg), 48)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(j_rec))


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = _build.build_host("frame_math_host", ["frame_math_host.cpp"])
    lib.frame_math_host.argtypes = (
        [ctypes.POINTER(pt._Params)] + [ctypes.c_void_p] * 14)
    lib.frame_math_host.restype = None
    lib.frame_math_host_bwd.argtypes = (
        [ctypes.POINTER(pt._Params), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 15)
    lib.frame_math_host_bwd.restype = None
    lib.pathtrace_bwd_smem_bytes.argtypes = [ctypes.POINTER(pt._Params)]
    lib.pathtrace_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def host_records(lib, tabs, planes, seed, static):
    """The records variant of K1's math, built for the host."""
    n = planes[0].shape[0]
    args = pt._kernel_args(tabs, planes)
    out = [torch.empty(n) for _ in range(3)]
    rec = torch.empty((pt._static_n_records(static), n), dtype=torch.int32)
    lib.frame_math_host(ctypes.byref(pt._params(n, seed, static)),
                        *(t.data_ptr() for t in args + out), rec.data_ptr())
    return out, rec


def host_backward(lib, tabs, planes, rec, g, seed, static, lanes=1,
                  blocks=3):
    """The hand-written adjoint (K2's math), built for the host and run on
    the kernel's schedule: `blocks` blocks, `lanes` lanes per sample (by
    default the launcher's 1)."""
    n = planes[0].shape[0]
    args = pt._kernel_args(tabs, planes)
    flat = torch.zeros(sum(r * w for r, w in pt.grad_layout(static)))
    cot = [g[:, c].contiguous() for c in range(3)]
    lib.frame_math_host_bwd(ctypes.byref(pt._params(n, seed, static)), lanes,
                            blocks, *(t.data_ptr() for t in args),
                            rec.contiguous().data_ptr(),
                            *(t.data_ptr() for t in cot), flat.data_ptr())
    return pt.split_grads(flat, static)


@pytest.mark.parametrize("case", KERNEL_CASES[:5],
                         ids=[c[0] for c in KERNEL_CASES[:5]])
def test_host_records_match_plain_version(host_lib, case):
    name, scene_name, overrides = case
    scene, cfg = case_scene_and_config(scene_name, overrides, 8, 6, "cpu")
    tabs, planes, static = _planes(scene, cfg, 48 * cfg.samples_per_pixel)
    out, rec = host_records(host_lib, tabs, planes, 11, static)
    *plain, prec = pt.frame_math_torch(tabs, planes, 11, emit_records=True,
                                       **static)
    assert torch.equal(rec, prec), name
    fwd = pt.frame_math_torch(tabs, planes, 11, **static)
    assert all(torch.equal(a, b) for a, b in zip(plain, fwd))


# Adjoint cases: (name, scene, overrides) beyond the kernel cases: shadows
# on and off, point and directional lights, fog, triangles, parity and
# clean, depth 1 to 3, Blinn-Phong without Monte-Carlo, jittered samples.
ADJOINT_CASES = KERNEL_CASES[:5] + [
    ("spheres1_parity_depth3", "spheres1.scn",
     dict(monte_carlo=True, num_paths=2, max_depth=3, use_shadows=True)),
    ("test_parity_blinn_phong", "test", dict(use_shadows=True)),
    ("test_clean_depth3", "test",
     dict(monte_carlo=True, num_paths=2, max_depth=3, use_shadows=True,
          mode="clean")),
    ("test_clean_no_shadows", "test",
     dict(monte_carlo=True, num_paths=2, max_depth=2, mode="clean")),
    ("test_clean_depth1_jsample2", "test",
     dict(grid_size=2, monte_carlo=True, num_paths=2, max_depth=1,
          use_shadows=True, mode="clean")),
]


@pytest.mark.parametrize("case", ADJOINT_CASES,
                         ids=[c[0] for c in ADJOINT_CASES])
def test_host_adjoint_matches_autograd_of_plain_replay(host_lib, case):
    name, scene_name, overrides = case
    scene, cfg = case_scene_and_config(scene_name, overrides, 8, 6, "cpu")
    n = 48 * cfg.samples_per_pixel
    tabs, planes, static = _planes(scene, cfg, n)
    *_, rec = pt.frame_math_torch(tabs, planes, 3, emit_records=True,
                                  **static)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, 3)).astype(np.float32))
    got = host_backward(host_lib, tabs, planes, rec, g, 3, static)
    want = pt.pathtrace_backward(tabs, planes, rec, g, 3, static)
    assert sum(float(w.abs().max()) for w in want) > 0, name
    for tname, a, w in zip(("sph", "tri", "misc", "pl", "dl"), got, want):
        assert a.shape == w.shape
        tol = 1e-4 * float(w.abs().max()) + 1e-6
        err = float((a - w).abs().max())
        assert err <= tol, (name, tname, err, tol)


def test_replay_oracle_matches_records_forward():
    """tests/test_pathtrace.py::test_replay_value_matches_kernel: the
    records replayed through the wavefront-style oracle reproduce the
    forward's radiance."""
    cfg = RenderConfig(width=16, height=12, monte_carlo=True, num_paths=3,
                       max_depth=3, use_shadows=True, backend="torch")
    scene = parse_scene_text(SPHERES_SCN).to_scene(cfg.quirks)
    ids = torch.arange(16 * 12)
    assert pt._can_replay(scene, cfg)
    tabs, planes, static = _planes(scene, cfg, 16 * 12)
    r, g, b, rec = pt.frame_math_torch(tabs, planes, 9, emit_records=True,
                                       **static)
    replayed = pt._replay_chunked(scene, cfg, 9, ids, rec)
    np.testing.assert_allclose(replayed.numpy(),
                               torch.stack([r, g, b], 1).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_fixed_topology_fd_matches_analytic():
    """tests/test_pathtrace.py::test_fixed_topology_fd_matches_analytic on
    the port: with the records and the tangent-frame branches frozen, the
    replay is smooth in the sphere centres, and its autograd gradient
    matches central differences."""
    cfg = RenderConfig(width=12, height=8, monte_carlo=True, num_paths=2,
                       max_depth=2, use_shadows=True, backend="torch")
    scene = parse_scene_text(SPHERES_SCN).to_scene(cfg.quirks)
    ids = torch.arange(12 * 8)
    tabs, planes, static = _planes(scene, cfg, 12 * 8)
    *_, rec = pt.frame_math_torch(tabs, planes, 9, emit_records=True,
                                  **static)
    bits = pt.replay_frame_bits(scene, cfg, 9, ids, rec)
    w = torch.linspace(0.5, 1.5, 12 * 8 * 3).reshape(-1, 3)

    def loss(center):
        import dataclasses

        s = dataclasses.replace(scene, spheres=dataclasses.replace(
            scene.spheres, center=center))
        r = pt._replay_chunked(s, cfg, 9, ids, rec, frame_bits=bits)
        return (r * w).sum()

    base = scene.spheres.center.clone()
    c = base.clone().requires_grad_(True)
    ga = torch.autograd.grad(loss(c), c)[0].double().numpy()
    mask = scene.spheres.mask.numpy() > 0
    eps = 1e-2
    fd = np.zeros_like(ga)
    with torch.no_grad():
        for i in np.nonzero(mask)[0]:
            for j in range(3):
                d = torch.zeros_like(base)
                d[i, j] = eps
                fd[i, j] = (float(loss(base + d)) - float(loss(base - d))) / (
                    2 * eps)
    num = np.linalg.norm((ga - fd)[mask])
    den = max(np.linalg.norm(fd[mask]), 1e-9)
    assert num / den < 1e-2, (num / den, ga, fd)

"""The backward kernel K2's lane split (csrc/pathtrace_bwd.cu), on the CPU.

On the card a sample is spread over G lanes: each lane replays the primary
hit and runs the adjoints of its share of the paths (frame_adjoint.cuh
`lane_bwd`), the group sums the lanes' adjoints of the primary state with
an xor butterfly, and lane 0 finishes the primary hit (`finish_bwd`).
Light, misc and fog gradients are summed per thread and reduced once per
block in thread order; primitive rows are summed per warp, lanes that hold
the same row grouped and summed in lane order. frame_math_host.cpp runs
that schedule serially (blocks, warps, lanes, every sum in the kernel's
order), built with g++ -ffp-contract=off. The launcher takes 1 lane; the
others run for measurement, and are held here all the same.

Those per-thread light sums take 3.6 KiB of the block's shared memory a
light, so the records route takes at most MAX_REPLAY_LIGHTS lights (22
with shadows, whose bits fill the record); the block's size is read from
the host build of the kernel's layout, and the split adjoint is held at
both limits.

Tolerances: against `torch.autograd.grad` of the plain replay, per table
|host - plain| <= 1e-4 * max|plain| + 1e-6 (tests/test_torch_pathtrace_bwd.py's:
the same float32 math summed in another order); against `jax.grad` of the
JAX package's jnp path, rtol 1e-3, atol 1e-5 (tests/test_torch_grad.py's).
Two runs on the same schedule are bitwise equal.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import case_scene_and_config
from skele_raytracer_tpu.config import RenderConfig as JConfig
from skele_raytracer_tpu.models.renderer import (
    render_ids_chunked as j_render_ids_chunked,
)
from skele_raytracer_tpu.scene.parser import parse_scene as j_parse
from skele_raytracer_tpu_torch.config import RenderConfig
from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)
from skele_raytracer_tpu_torch.scene.types import leaf_items
from tests.test_torch_pathtrace_bwd import (
    ADJOINT_CASES,
    _planes,
    host_backward,
    host_lib,  # noqa: F401  (fixture)
)

REPO = __file__.rsplit("/", 2)[0]
TABLES = ("sph", "tri", "misc", "pl", "dl")
_PLAIN = {}


def adjoint_case(name):
    """(tabs, planes, static, records, cotangent, the plain version's table
    gradients) of an ADJOINT_CASES entry at 8x6, computed once."""
    if name not in _PLAIN:
        _, scene_name, overrides = next(c for c in ADJOINT_CASES
                                        if c[0] == name)
        scene, cfg = case_scene_and_config(scene_name, overrides, 8, 6, "cpu")
        n = 48 * cfg.samples_per_pixel
        tabs, planes, static = _planes(scene, cfg, n)
        *_, rec = pt.frame_math_torch(tabs, planes, 3, emit_records=True,
                                      **static)
        g = torch.from_numpy(np.random.default_rng(1).normal(
            size=(n, 3)).astype(np.float32))
        want = pt.pathtrace_backward(tabs, planes, rec, g, 3, static)
        _PLAIN[name] = (tabs, planes, static, rec, g, want)
    return _PLAIN[name]


def assert_close_to_plain(got, want, label):
    assert sum(float(w.abs().max()) for w in want) > 0, label
    for tname, a, w in zip(TABLES, got, want):
        assert a.shape == w.shape
        tol = 1e-4 * float(w.abs().max()) + 1e-6
        err = float((a - w).abs().max())
        assert err <= tol, (label, tname, err, tol)


@pytest.mark.parametrize("lanes", [1, 2, 4, 16])
@pytest.mark.parametrize("case", [c[0] for c in ADJOINT_CASES])
def test_split_adjoint_matches_autograd_of_plain_replay(host_lib, case,
                                                        lanes):
    tabs, planes, static, rec, g, want = adjoint_case(case)
    got = host_backward(host_lib, tabs, planes, rec, g, 3, static,
                        lanes=lanes, blocks=5)
    assert_close_to_plain(got, want, (case, lanes))


@pytest.mark.parametrize("lanes, blocks", [(1, 1), (4, 3), (8, 7)])
def test_split_adjoint_is_bitwise_reproducible(host_lib, lanes, blocks):
    """Every sum in an order fixed by the launch shape: two runs equal to
    the bit; another shape sums in another order but stays within the
    tolerance."""
    tabs, planes, static, rec, g, want = adjoint_case(
        "spheres2_clean_gillum4_fog")
    runs = [host_backward(host_lib, tabs, planes, rec, g, 3, static,
                          lanes=lanes, blocks=blocks) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert_close_to_plain(runs[0], want, (lanes, blocks))


def test_split_adjoint_ignores_padding_samples(host_lib):
    """Threads past the last sample (a ragged last stride, lanes that own
    no path: P = 2 at 4 lanes) add nothing: 47 samples give what the
    plain version gives for 47."""
    tabs, planes, static, rec, g, _ = adjoint_case("test_parity_gillum4")
    n = 47
    cut = tuple(p[:n].contiguous() for p in planes)
    rec_n, g_n = rec[:, :n].contiguous(), g[:n].contiguous()
    want = pt.pathtrace_backward(tabs, cut, rec_n, g_n, 3, static)
    for lanes in (4, 8):
        got = host_backward(host_lib, tabs, cut, rec_n, g_n, 3, static,
                            lanes=lanes, blocks=2)
        assert_close_to_plain(got, want, lanes)


def lights_case(lights, shadows, width=8, height=6):
    """(scene, cfg) of spheres2 with `lights` lights (chip_smoke.py
    `lit_spheres2_text`), clean, gillum 4, depth 2, on the CPU."""
    kw = dict(monte_carlo=True, num_paths=4, max_depth=2, mode="clean",
              use_shadows=shadows)
    return case_scene_and_config(f"lights{lights}", kw, width, height, "cpu")


@pytest.mark.parametrize("lights, shadows, want", [
    (22, True, True), (23, True, False), (32, False, True),
    (33, False, False)])
def test_replay_takes_at_most_max_replay_lights(lights, shadows, want):
    """The records route takes 22 lights with shadows (their unshadowed
    bits fill the record) and MAX_REPLAY_LIGHTS without (the backward
    kernel's shared memory); past them the gradient takes the wavefront."""
    scene, cfg = lights_case(lights, shadows)
    assert (scene.point_lights.mask.shape[0]
            + scene.directional_lights.mask.shape[0]) == lights
    assert pt._can_replay(scene, cfg) == want


@pytest.mark.parametrize("L, LD", [(32, 0), (0, 32), (20, 12)])
def test_backward_block_fits_shared_memory(host_lib, L, LD):
    """At MAX_REPLAY_LIGHTS lights and the largest tables the replay takes
    (64 spheres, 32 triangles, 2 fog volumes), a block of the backward
    kernel fits in the shared memory an sm_90 block may use."""
    from skele_raytracer_tpu_torch.ops.cuda import culled

    _, _, static, *_ = adjoint_case("spheres2_clean_gillum4_fog")
    assert L + LD == pt.MAX_REPLAY_LIGHTS
    big = dict(static, S=pt.MAX_REPLAY_SPHERES, T=pt.MAX_TRIS, F=pt.MAX_FOG,
               L=L, LD=LD)
    smem = host_lib.pathtrace_bwd_smem_bytes(ctypes.byref(pt._params(
        64, 3, big)))
    assert 170_000 < smem <= culled.SMEM_LIMIT
    more = dict(big, L=L + 1)
    assert host_lib.pathtrace_bwd_smem_bytes(ctypes.byref(pt._params(
        64, 3, more))) - smem == 4 * (8 + 7 * 129)  # a light's row and sums


@pytest.mark.parametrize("lights, shadows", [(22, True), (32, False)])
def test_split_adjoint_at_most_lights(host_lib, lights, shadows):
    """The host split adjoint at the most lights the replay takes, against
    autograd of the plain replay, at 1 and 4 lanes."""
    scene, cfg = lights_case(lights, shadows)
    n = 48 * cfg.samples_per_pixel
    tabs = pt._pack_tables(scene)
    planes = pt._plane_inputs(cfg, torch.arange(n))
    static = pt._static_kernel_args(scene, cfg)
    *_, rec = pt.frame_math_torch(tabs, planes, 3, emit_records=True,
                                  **static)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, 3)).astype(np.float32))
    want = pt.pathtrace_backward(tabs, planes, rec, g, 3, static)
    assert float(want[3].abs().max()) > 0
    for lanes in (1, 4):
        got = host_backward(host_lib, tabs, planes, rec, g, 3, static,
                            lanes=lanes, blocks=2)
        assert_close_to_plain(got, want, (lights, lanes))


def test_split_adjoint_matches_jax_grad_on_spheres2(host_lib):
    """spheres2 parity at 12x8, gillum 4, depth 2, shadows: the host split
    adjoint's table cotangents mapped onto the scene leaves by autograd of
    `_pack_tables` (as `_PathTrace` does) against `jax.grad` of the JAX
    package's jnp path, loss sum(r^2)."""
    kw = dict(width=12, height=8, monte_carlo=True, num_paths=4, max_depth=2,
              use_shadows=True)
    jcfg = JConfig(backend="jnp", **kw)
    tcfg = RenderConfig(backend="torch", **kw)
    jscene = j_parse(f"{REPO}/scenes/spheres2.scn").to_scene(jcfg.quirks)
    n = 12 * 8 * tcfg.samples_per_pixel
    ids = jnp.arange(n, dtype=jnp.uint32)

    def loss(s):
        r = j_render_ids_chunked(s, jcfg, jnp.uint32(3), ids)
        return jnp.sum(r * r)

    want, _ = scene_to_numpy(jax.grad(loss)(jscene))
    scene = scene_from_numpy(*scene_to_numpy(jscene))
    leaves = dict(leaf_items(scene))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    assert pt.use_pathtrace(scene, tcfg) and pt._can_replay(scene, tcfg)
    tabs = pt._pack_tables(scene)
    planes = pt._plane_inputs(tcfg, torch.arange(n))
    static = pt._static_kernel_args(scene, tcfg)
    detached = [t.detach() for t in tabs]
    r, gch, b, rec = pt.frame_math_torch(detached, planes, 3,
                                         emit_records=True, **static)
    g = 2.0 * torch.stack([r, gch, b], 1)
    grads = host_backward(host_lib, detached, planes, rec, g, 3, static,
                          lanes=4, blocks=2)
    pairs = [(t, d) for t, d in zip(tabs, grads) if t.requires_grad]
    torch.autograd.backward([t for t, _ in pairs], [d for _, d in pairs])
    checked = 0
    for name, leaf in leaves.items():
        w = np.asarray(want[name], np.float64)
        got = (np.zeros_like(w) if leaf.grad is None
               else leaf.grad.double().numpy())
        np.testing.assert_allclose(got, w, rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        checked += bool(np.abs(w).sum() > 0)
    assert checked >= 3

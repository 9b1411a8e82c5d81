"""Rays sharded over devices in one process (parallel/api.py), on the CPU:
tests/test_sharding.py's cases on the port, and the sharded frame and
gradients held against the JAX package's on the same inputs.

The CPU has one device, so a mesh of n shards here is n shards of "cpu"
(a device may hold several shards); the shards are cut and run exactly as
on n cards. Tolerances are test_sharding.py's: threefry streams bitwise;
sharded frames within rtol 5e-7, atol 1e-7 of single-device ones (the
whole-frame path computes each ray on its own, so here they are in fact
bitwise); mesh shapes bitwise; gradients within atol 1e-5, rtol 1e-3.
Against JAX: the frame at the same tolerance, on spheres2 (a K1 sphere
scene: on test.scn at fov 60 XLA's FMA contraction flips silhouette rays,
ROADMAP queue 3); the loss within 1e-5 relative and each leaf's gradient
within atol 1e-5, rtol 1e-3 of `jax.value_and_grad(train.full_loss)` with
backend "jnp".
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import k5_mesh_scene
from skele_raytracer_tpu.config import RenderConfig as JConfig
from skele_raytracer_tpu.models import train as j_train
from skele_raytracer_tpu.parallel.api import make_mesh as j_make_mesh
from skele_raytracer_tpu.parallel.api import (
    render_radiance_sharded as j_render_radiance_sharded,
)
from skele_raytracer_tpu.scene.parser import parse_scene as j_parse
from skele_raytracer_tpu_torch import cli
from skele_raytracer_tpu_torch.config import RenderConfig
from skele_raytracer_tpu_torch.models import train
from skele_raytracer_tpu_torch.models.renderer import render_radiance
from skele_raytracer_tpu_torch.ops import sampling
from skele_raytracer_tpu_torch.parallel import api
from skele_raytracer_tpu_torch.parallel import (
    factor_mesh,
    loss_and_grad_sharded,
    make_mesh,
    render_radiance_sharded,
    render_sharded,
    replicate_scene,
)
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)
from skele_raytracer_tpu_torch.scene.parser import parse_scene_text
from skele_raytracer_tpu_torch.scene.types import (
    leaf_items,
    refresh_clusters,
    replace_leaves,
)
from tests.conftest import TEST_SCN, assert_images_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=40, height=24, grid_size=2, monte_carlo=True,
                   num_paths=2, max_depth=2, use_shadows=True,
                   rays_per_chunk=1 << 10, backend="torch")
# the gradient and training cases at a quarter of the rays (the plain
# version of the backward kernel is slow on the CPU)
SMALL = CFG.replace(width=20, height=12)


def cpu_mesh(n, axis_sizes=None):
    return make_mesh(["cpu"] * n, axis_sizes)


@pytest.fixture(scope="module")
def scene():
    return parse_scene_text(TEST_SCN).to_scene(CFG.quirks)


def _with_grad(scene):
    return replace_leaves(scene, [t.detach().requires_grad_(True)
                                  for _, t in leaf_items(scene)])


def test_factor_mesh():
    assert factor_mesh(8) == (4, 2)
    assert factor_mesh(1) == (1, 1)
    assert factor_mesh(7) == (7, 1)
    assert factor_mesh(16) == (4, 4)


def test_sharded_render_matches_single_device(scene):
    # the RNG itself is bitwise partition-invariant (the counter-based
    # contract sharding is built on) ...
    ids = torch.arange(CFG.width * CFG.height, dtype=torch.int64)
    full = sampling.uniform(3, ids, 1, sampling.PURPOSE_PATH, (2,))
    parts = torch.cat([
        sampling.uniform(3, ids[i:i + 97], 1, sampling.PURPOSE_PATH, (2,))
        for i in range(0, ids.shape[0], 97)])
    assert torch.equal(full, parts)
    # ... and so is the frame, 8 and 4 shards against one device
    with torch.no_grad():
        single = render_radiance(scene, CFG, 3).numpy()
        for n in (8, 4):
            sharded = render_radiance_sharded(scene, CFG, 3,
                                              cpu_mesh(n)).numpy()
            np.testing.assert_allclose(
                single, sharded, rtol=5e-7, atol=1e-7,
                err_msg=f"{n}-shard render differs from single-device")


def test_sharded_render_mesh_shape_invariance(scene):
    a = render_sharded(scene, CFG, 3, cpu_mesh(8, (8, 1)))
    b = render_sharded(scene, CFG, 3, cpu_mesh(8, (2, 4)))
    assert torch.equal(a, b)


def test_sharded_wavefront_matches_single_device():
    """A mesh scene takes the chunked wavefront (K5's plain version): its
    shards, the last padded past the frame (192 rays in 5 shards of 39),
    render the same frame."""
    cfg = RenderConfig(width=16, height=12, use_shadows=True,
                       rays_per_chunk=1 << 7, backend="torch")
    mesh_scene = k5_mesh_scene()
    with torch.no_grad():
        single = render_radiance(mesh_scene, cfg, 0).numpy()
        sharded = render_sharded(mesh_scene, cfg, 0, cpu_mesh(5)).numpy()
    np.testing.assert_allclose(single, sharded, rtol=5e-7, atol=1e-7)


def test_sharded_grads_match_single_device(scene):
    target = torch.zeros(SMALL.height, SMALL.width, 3)
    loss_s, grad_s = loss_and_grad_sharded(scene, SMALL, 5, target,
                                           cpu_mesh(8))
    ref = _with_grad(scene)
    loss_1 = train.full_loss(ref, SMALL, 5, target)
    grad_1 = torch.autograd.grad(loss_1, [t for _, t in leaf_items(ref)],
                                 allow_unused=True)
    loss_1 = float(loss_1.detach())
    assert np.isclose(float(loss_s), loss_1, rtol=1e-5), (loss_s, loss_1)
    assert set(grad_s) == {name for name, _ in leaf_items(scene)}
    assert any(float(g.abs().sum()) > 0 for g in grad_s.values())
    for (name, leaf), g1 in zip(leaf_items(ref), grad_1):
        g1 = torch.zeros_like(leaf) if g1 is None else g1
        assert_images_close(grad_s[name], g1, atol=1e-5, rtol=1e-3,
                            what=f"grad {name}")


def test_sharded_grads_only_for_leaves_that_require_grad(scene):
    wants = {"spheres.diffuse", "point_lights.colour"}
    part = replace_leaves(scene, [
        t.detach().requires_grad_(name in wants)
        for name, t in leaf_items(scene)])
    target = torch.zeros(SMALL.height, SMALL.width, 3)
    _, grads = loss_and_grad_sharded(part, SMALL, 5, target, cpu_mesh(2))
    assert set(grads) == wants


def test_train_step_runs_and_descends(scene):
    state = train.init_state(scene, 5e-3)
    with torch.no_grad():
        target = render_radiance(scene, SMALL, 9)
    losses = []
    for _ in range(3):
        state, loss = train.train_step(state, SMALL, 0, target,
                                       mesh=cpu_mesh(8))
        losses.append(float(loss))
    assert all(np.isfinite(x) for x in losses)
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 3


def test_sharded_train_step_matches_unsharded_step(scene):
    """One sharded step and one unsharded step from the same state move
    the leaves alike (Adam on gradients that agree to rounding)."""
    target = torch.zeros(SMALL.height, SMALL.width, 3)
    trainable = train.make_trainable_mask(scene, ("spheres.diffuse",))
    a, loss_a = train.train_step(train.init_state(scene, 1e-2), SMALL, 3,
                                 target, trainable=trainable)
    b, loss_b = train.train_step(train.init_state(scene, 1e-2), SMALL, 3,
                                 target, mesh=cpu_mesh(4),
                                 trainable=trainable)
    np.testing.assert_allclose(float(loss_b), float(loss_a), rtol=1e-6)
    for (name, x), (_, y) in zip(leaf_items(a.scene), leaf_items(b.scene)):
        np.testing.assert_allclose(y.detach().numpy(), x.detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        if name != "spheres.diffuse":  # the mask freezes the rest
            assert torch.equal(y, dict(leaf_items(scene))[name]), name


def test_mesh_validation(scene):
    with pytest.raises(ValueError, match="axis sizes"):
        make_mesh(["cpu"] * 4, (3, 1))
    mesh = make_mesh([torch.device("cuda", 0)])
    assert mesh.n_shards == 1 and mesh.group is None and mesh.world == 1
    # a shard's device must be the backend's
    with pytest.raises(ValueError, match="backend"):
        render_sharded(scene, CFG, 0, mesh)
    assert [k for k, _ in cpu_mesh(3).local_shards()] == [0, 1, 2]


def test_default_mesh_needs_a_gpu(monkeypatch):
    """With no GPU visible the default mesh raises, naming the CPU mesh,
    rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r'make_mesh\(\["cpu"\] \* n\)'):
        make_mesh()
    assert make_mesh(["cpu"] * 2).n_shards == 2


def test_scaling_report_needs_a_gpu(monkeypatch, scene):
    from skele_raytracer_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        multihost.scaling_report(scene, CFG, iters=1)


def test_render_sharded_default_mesh_follows_the_backend(monkeypatch,
                                                         scene):
    """`render_sharded` with no mesh: under backend "torch" one shard on
    the CPU (the one-shard frame, bitwise); under the default "cuda" with
    no GPU it raises as `RenderConfig.resolved` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meshes = []

    def spy(*args, **kw):
        meshes.append(make_mesh(*args, **kw))
        return meshes[-1]

    monkeypatch.setattr(api, "make_mesh", spy)
    cfg = CFG.replace(width=16, height=8)
    got = render_sharded(scene, cfg, 3)
    assert [m.devices for m in meshes] == [(torch.device("cpu"),)]
    assert torch.equal(got, render_sharded(scene, cfg, 3, cpu_mesh(1)))
    with pytest.raises(RuntimeError, match="backend"):
        render_sharded(scene, cfg.replace(backend="cuda"), 3)


def test_replicate_scene_one_copy_per_device(scene):
    copies = replicate_scene(scene, cpu_mesh(4))
    assert list(copies) == [torch.device("cpu")]
    assert copies[torch.device("cpu")].spheres.center is scene.spheres.center


def test_replicate_scene_keeps_a_resident_copy(scene):
    """Without autograd a device other than the scene's keeps one copy,
    its tensors the same from frame to frame (the CUDA graphs key on their
    addresses); a scene of another layout gets a new copy; under autograd
    every call copies anew (`scene.to`, differentiable)."""
    meta = torch.device("meta")
    mesh = make_mesh([meta, meta])
    with torch.no_grad():
        first = replicate_scene(scene, mesh)[meta]
        again = replicate_scene(scene, mesh)[meta]
    assert again is first
    assert all(t.device == meta for t in first.tensors())
    grown = dataclasses.replace(scene, ambient=torch.zeros(4))
    with torch.no_grad():
        other = replicate_scene(grown, mesh)[meta]
    assert other is not first and other.ambient.shape == (4,)
    leaf = dataclasses.replace(
        scene, ambient=scene.ambient.clone().requires_grad_(True))
    a, b = (replicate_scene(leaf, mesh)[meta] for _ in range(2))
    assert a is not b and a.ambient.requires_grad


def test_resident_copy_refresh_carries_the_sort_key_tables(monkeypatch):
    """A resident copy refreshed from a scene of the same layout but a
    rebuilt mesh (`refresh_clusters` after moving the vertices) holds the
    new mesh's sort-key tables, which the card's sort kernel reads. The
    device "cpu:0" is never a CPU tensor's device, so `_resident` takes
    its copy path here with real values."""
    monkeypatch.setattr(api, "_RESIDENT", {})
    dev = torch.device("cpu", 0)
    scene = k5_mesh_scene(t=1200)
    first = api._resident(scene, dev)
    assert first is not scene
    tri = scene.triangles
    moved = refresh_clusters(dataclasses.replace(scene, triangles=(
        dataclasses.replace(tri, v0=tri.v0 * 1.5, v1=tri.v1 * 1.5,
                            v2=tri.v2 * 1.5))))
    again = api._resident(moved, dev)
    assert again is first
    for mesh in ("clusters", "clusters_fine"):
        old, new, copy = (getattr(s, mesh) for s in (scene, moved, again))
        for mirrored in (False, True):
            table = copy.sort_table(mirrored=mirrored)
            assert torch.equal(table, new.sort_table(mirrored=mirrored))
            assert not torch.equal(table, old.sort_table(mirrored=mirrored))


def test_pad_ids_and_target_rows():
    assert api._pad_ids(10, 4) == 3 and api._pad_ids(12, 4) == 3
    assert api._shard_ids(2, 3, "cpu").tolist() == [6, 7, 8]
    t = torch.arange(2 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3)
    rows = api._target_rows(t, 2, 3, 2, 14)
    assert rows.shape == (14, 3)
    assert torch.equal(rows[0], rows[1]) and torch.equal(rows[0], t[0, 0])
    assert torch.equal(rows[11], t[1, 2]) and torch.equal(rows[13], t[1, 2])


# --- against the JAX package on the same inputs -------------------------

JKW = dict(width=32, height=18, monte_carlo=True, num_paths=2, max_depth=2,
           use_shadows=True, rays_per_chunk=1 << 10)


@pytest.fixture(scope="module")
def spheres2():
    jcfg = JConfig(backend="jnp", **JKW)
    jscene = j_parse(os.path.join(REPO, "scenes",
                                  "spheres2.scn")).to_scene(jcfg.quirks)
    return jscene, jcfg, scene_from_numpy(*scene_to_numpy(jscene))


def test_sharded_frame_matches_jax_sharded_frame(spheres2):
    jscene, jcfg, tscene = spheres2
    jmesh = j_make_mesh(jax.devices())  # conftest's 8 CPU devices
    want = np.asarray(jax.jit(
        lambda s, k: j_render_radiance_sharded(s, jcfg, k, jmesh))(
            jscene, jnp.uint32(3)))
    got = render_sharded(tscene, RenderConfig(backend="torch", **JKW), 3,
                         cpu_mesh(len(jax.devices()))).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-7)


def test_sharded_loss_and_grad_match_jax(spheres2):
    jscene, jcfg, tscene = spheres2
    target = np.zeros((JKW["height"], JKW["width"], 3), np.float32)
    target[::2] = 0.25
    j_loss, j_grad = jax.value_and_grad(j_train.full_loss)(
        jscene, jcfg, jnp.uint32(5), jnp.asarray(target))
    want, _ = scene_to_numpy(j_grad)
    loss, grads = loss_and_grad_sharded(
        tscene, RenderConfig(backend="torch", **JKW), 5, target,
        cpu_mesh(8))
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * float(j_loss)
    assert any(np.abs(want[name]).sum() > 0 for name in grads)
    for name, g in grads.items():
        assert_images_close(g.numpy(), want[name], atol=1e-5, rtol=1e-3,
                            what=f"grad {name}")


def test_cli_mesh_renders_the_no_mesh_bytes(tmp_path):
    """--mesh (the default) no longer exits 2; on the CPU it renders the
    bytes --no-mesh does."""
    outs = []
    for flag in ("--mesh", "--no-mesh"):
        out = str(tmp_path / f"{flag[2:]}.ppm")
        rc = cli.main(["--path", os.path.join(REPO, "scenes", "spheres1.scn"),
                       "--width", "24", "--height", "18", "--shadow",
                       "--backend", "torch", flag, "--output", out])
        assert rc == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]

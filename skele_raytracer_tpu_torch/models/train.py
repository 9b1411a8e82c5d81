"""Inverse rendering: gradient descent on scene parameters against a
target image (the JAX package's models/train.py).

Every scene leaf (sphere centers and radii, triangle vertices, materials,
lights, fog, camera, ambient, background: `scene.types.leaf_items`) is a
parameter; `make_trainable_mask` restricts which ones move. The loss is
the per-sample mean squared error of `render_ids_chunked` against the
target, whose gradient runs through the backward kernel K2 on small
scenes and through the wavefront's autograd (with the mesh kernels' t
replayed) on meshes. The optimizer is torch's Adam with optax's adam
defaults. A `TrainState` checkpoints through utils/checkpoint.py.

With a `mesh` (parallel/api.py) the loss and its gradient come from
`loss_and_grad_sharded`: rays sharded over devices and processes, one
all-reduce of the gradients; every rank then applies the same mask and
Adam update, so the replicated leaves stay equal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from skele_raytracer_tpu_torch.config import RenderConfig
from skele_raytracer_tpu_torch.models.renderer import render_ids_chunked
from skele_raytracer_tpu_torch.parallel.api import loss_and_grad_sharded
from skele_raytracer_tpu_torch.scene.types import (
    Scene,
    leaf_items,
    refresh_clusters,
    replace_leaves,
    scene_leaves,
)
from skele_raytracer_tpu_torch.utils import profiling

_MASK = 0xFFFFFFFF


class TrainState(NamedTuple):
    scene: Scene  # its leaves are the optimizer's parameters
    optimizer: torch.optim.Optimizer
    step: int


def _as_image(target, device) -> torch.Tensor:
    """A target image (tensor or array) as a float32 tensor on `device`."""
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, np.float32))
    return target.to(device=device, dtype=torch.float32)


def make_optimizer(params, learning_rate: float = 1e-2) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def init_state(scene: Scene, learning_rate: float = 1e-2,
               trainable=None) -> TrainState:
    """A fresh state: the scene's leaves copied into parameters (those
    `trainable` selects require grad; all of them without a mask) and an
    Adam over all of them."""
    params = []
    for path, leaf in leaf_items(scene):
        on = trainable is None or bool(trainable[path].any())
        params.append(leaf.detach().clone().requires_grad_(on))
    scene = replace_leaves(scene, params)
    return TrainState(scene, make_optimizer(params, learning_rate), 0)


def full_loss(scene, cfg: RenderConfig, key, target):
    """Per-sample mean squared error against `target` [H, W, 3]: each
    supersample is compared to its pixel's target value (the target is
    broadcast per supersample in id order, not gathered)."""
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    cfg = cfg.resolved()
    ids = torch.arange(H * W * spp, dtype=torch.int64, device=cfg.device)
    radiance = render_ids_chunked(scene, cfg, key, ids)
    t = _as_image(target, radiance.device).reshape(H * W, 1, 3)
    t = t.expand(H * W, spp, 3).reshape(H * W * spp, 3)
    err = radiance - t
    return torch.mean(err * err)


def make_trainable_mask(scene, paths) -> dict:
    """{dotted leaf path: 0/1 tensor like the leaf} selecting the leaves
    that train; `paths` are dotted-path prefixes (e.g. "spheres.diffuse",
    "point_lights")."""
    return {name: torch.full_like(leaf.detach(), 1.0 if any(
        name.startswith(p) for p in paths) else 0.0)
            for name, leaf in leaf_items(scene)}


@profiling.spanned("train.step")
def train_step(state: TrainState, cfg: RenderConfig, key, target,
               mesh=None, trainable: Optional[dict] = None):
    """One optimization step: loss and gradient of `full_loss` at the
    step's key (`key + step`), or of its sharded form over `mesh`
    (`loss_and_grad_sharded`, the same objective), the trainable mask, an
    Adam update. Leaves the mask zeroes (or that need no gradient) stay
    bitwise unchanged. Returns (new state, loss). Spans: `train.step`,
    and in it `train.loss`, `train.backward` (the sharded form's gradient
    is in its loss), `train.mask` and `train.update`."""
    key = (int(key) + int(state.step)) & _MASK
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    if mesh is None:
        with profiling.span("train.loss"):
            loss = full_loss(state.scene, cfg, key, target)
        with profiling.span("train.backward"):
            loss.backward()
    else:
        with profiling.span("train.loss"):
            loss, grads = loss_and_grad_sharded(state.scene, cfg, key,
                                                target, mesh)
        for name, leaf in leaf_items(state.scene):
            leaf.grad = grads.get(name)
    if trainable is not None:
        with profiling.span("train.mask"):
            for name, leaf in leaf_items(state.scene):
                if leaf.grad is None:
                    continue
                m = trainable[name].to(leaf.grad.device)
                leaf.grad = leaf.grad * m if bool(m.any()) else None
    with profiling.span("train.update"):
        opt.step()
    return state._replace(step=state.step + 1), loss.detach()


def fit(scene, cfg: RenderConfig, target, *, steps: int = 100,
        learning_rate: float = 1e-2, seed: int = 0, mesh=None,
        trainable_paths=None, checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50, log_every: int = 10):
    """Optimize the scene's leaves to match `target`; returns (fitted
    scene, losses of the steps this call ran). `trainable_paths`: dotted
    leaf-path prefixes that train (None: every leaf). Resumes from the
    newest checkpoint in `checkpoint_dir` and saves one every
    `checkpoint_every` steps and at the end. With a `mesh` every step is
    sharded (`train_step`); every rank runs the fit, and only rank 0 logs
    and writes checkpoints."""
    cfg = cfg.resolved()
    scene = scene.to(torch.device(cfg.device))
    trainable = (make_trainable_mask(scene, tuple(trainable_paths))
                 if trainable_paths else None)
    state = init_state(scene, learning_rate, trainable)
    # The mesh kernels (and their plain versions) read the Morton-clustered
    # copy of the triangles: rebuild it, and the normal table, before the
    # first step (the caller's scene, or a restored checkpoint, which holds
    # only the leaves, may carry a copy of other vertices) and after every
    # step that moves them.
    tri_moves = scene.triangles_active and (
        trainable_paths is None
        or any(p.startswith("triangles") for p in trainable_paths))
    start = 0
    if checkpoint_dir is not None:
        from skele_raytracer_tpu_torch.utils import checkpoint as ckpt

        restored = ckpt.restore_latest(checkpoint_dir, state)
        if restored is not None:
            state = restored
            start = int(state.step)
    if tri_moves:
        state = state._replace(scene=refresh_clusters(state.scene))
    target = _as_image(target, cfg.device)
    primary = mesh is None or mesh.rank == 0
    writes = checkpoint_dir is not None and primary
    losses = []
    for i in range(start, steps):
        state, loss = train_step(state, cfg, seed, target, mesh=mesh,
                                 trainable=trainable)
        if tri_moves:
            state = state._replace(scene=refresh_clusters(state.scene))
        losses.append(float(loss))
        if primary and log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i}: loss {losses[-1]:.6e}")
        if writes and (i + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, state)
    if writes and start < steps:
        ckpt.save(checkpoint_dir, state)
    fitted = replace_leaves(state.scene, [t.detach() for t in
                                          scene_leaves(state.scene)])
    return fitted, losses

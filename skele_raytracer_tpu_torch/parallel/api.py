"""Rays sharded over devices and processes: the sharded frame and the
sharded loss with one all-reduce of the gradients (the JAX package's
parallel/api.py).

The reference parallelizes one machine's image rows (an OpenMP pragma) and
nothing more. Here the flat ray-id space (pixel x spp) is cut into shards
over a ("tiles", "samples") mesh of devices, which may span processes of a
`torch.distributed` group:

* shard k of n takes the ids [k * per, (k + 1) * per) of the id list
  padded to n * per (`_pad_ids`: the ids continue past the frame; their
  rows are dropped, and the loss masks them by `id < n_total`). This
  process holds shards rank * n_local .. rank * n_local + n_local - 1, in
  the order of its devices: the JAX package's P(("tiles", "samples"));
* the scene is replicated: every shard reads it on its own device
  (`replicate_scene`);
* each shard runs the single-device renderer, `render_ids_chunked`, on its
  own device and unchanged: sharding composes around it. The forward pass
  communicates nothing;
* the gradient of the loss is a sum over rays, so the backward pass ends
  in ONE `all_reduce` of one flat buffer holding every leaf's gradient and
  the loss (the JAX package's single `psum`).

Rays are generated from their flat ids and every random draw is
counter-based (ops/sampling.py), so any partition of the ids renders the
same rays; a kernel computes each ray on its own, so the sharded frame of
the whole-frame path is bitwise the one-shot frame.

A device may hold several shards (the CPU has one device; one card may
stand in for several in a test).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, fields, is_dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from skele_raytracer_tpu_torch.config import RenderConfig
from skele_raytracer_tpu_torch.models.renderer import render_ids_chunked
from skele_raytracer_tpu_torch.scene.types import leaf_items, replace_leaves


def factor_mesh(n: int) -> Tuple[int, int]:
    """Split n devices into (tiles, samples) axis sizes, tiles-major.

    Prefers the most-square split with tiles >= samples so small meshes
    spend devices on the image axis first (the bigger axis in practice)."""
    best = (n, 1)
    for s in range(1, int(np.sqrt(n)) + 1):
        if n % s == 0:
            best = (n // s, s)
    return best


@dataclass(frozen=True)
class Mesh:
    """A ("tiles", "samples") mesh of shards: this process's devices, one
    shard each, in shard order; the axis sizes over every process's
    shards; the process group (None: this process alone)."""

    devices: Tuple[torch.device, ...]
    axis_sizes: Tuple[int, int]
    group: Optional[dist.ProcessGroup] = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def n_shards(self) -> int:
        return self.world * len(self.devices)

    def local_shards(self):
        """(global shard index, device) of this process's shards."""
        first = self.rank * len(self.devices)
        return [(first + j, d) for j, d in enumerate(self.devices)]


def _default_devices() -> list:
    """Every visible GPU; under a process group this rank's
    cuda:{LOCAL_RANK}. Raises where no GPU is visible: a mesh on the CPU
    names its devices (`make_mesh(["cpu"] * n)`)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no GPU is visible for the default mesh; shard on the CPU by "
            "naming its devices: make_mesh([\"cpu\"] * n)")
    if dist.is_initialized() and dist.get_world_size() > 1:
        return [torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              axis_sizes: Optional[Tuple[int, int]] = None) -> Mesh:
    """A ("tiles", "samples") mesh over this process's `devices` (default:
    `_default_devices`, every visible GPU; it raises where none is) and,
    when a process group of more than one rank is up, every rank's: each
    rank passes the same number of devices, and the axis sizes (default
    `factor_mesh`) cover world x len(devices) shards. A device may repeat
    (several shards on one device)."""
    devs = tuple(torch.device(d) for d in (
        devices if devices is not None else _default_devices()))
    group = (dist.group.WORLD if dist.is_initialized()
             and dist.get_world_size() > 1 else None)
    n = len(devs) * (1 if group is None else dist.get_world_size(group))
    t, s = axis_sizes if axis_sizes is not None else factor_mesh(n)
    if t * s != n:
        raise ValueError(f"axis sizes {t}x{s} != shard count {n}")
    return Mesh(devs, (t, s), group)


def _pad_ids(n_total: int, n_shards: int) -> int:
    """Ids per shard: the flat ray ids padded to a multiple of n_shards by
    continuing the sequence past the frame (out-of-frame ids produce
    harmless rays; the renderer drops the rows, the loss masks them by
    `id < n_total`)."""
    return -(-n_total // n_shards)


def _shard_ids(k: int, per: int, dev) -> torch.Tensor:
    """Shard k's ids, [k * per, (k + 1) * per), int64 on `dev`."""
    return torch.arange(k * per, (k + 1) * per, dtype=torch.int64,
                        device=dev)


def _check_devices(mesh: Mesh, cfg: RenderConfig) -> None:
    """Every shard's device is of the kind the resolved backend renders
    on (cards for "cuda", the CPU for "torch")."""
    want = torch.device(cfg.device).type
    for dev in mesh.devices:
        if dev.type != want:
            raise ValueError(f"a shard on {dev} under backend "
                             f"{cfg.backend!r}, which renders on {want}")


def _shard_device(dev: torch.device):
    """The context a shard renders in: its card current (the resolved
    "cuda" backend names the current card), nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _local_rows(scene, cfg, seed, mesh, per):
    """Radiance rows [len(mesh.devices) * per, 3] of this process's
    shards, in shard order, on its first device."""
    copies = replicate_scene(scene, mesh)
    rows = []
    for k, dev in mesh.local_shards():
        with _shard_device(dev):
            rows.append(render_ids_chunked(copies[dev], cfg, seed,
                                           _shard_ids(k, per, dev)))
    first = mesh.devices[0]
    return torch.cat([r.to(first) for r in rows])


def _frame(rows, height, width, spp):
    """[H, W, 3]: the first H * W * spp rows, each pixel's spp mean."""
    return rows[:height * width * spp].reshape(height, width, spp,
                                               3).mean(dim=2)


class FramePart(NamedTuple):
    """This process's part of a frame rendered over several processes: the
    radiance rows of its shards ([n_local * per, 3], in shard order) and
    the frame's (height, width, spp). `multihost.gather_image` assembles
    the frame on rank 0."""

    rows: torch.Tensor
    height: int
    width: int
    spp: int


def render_radiance_sharded(scene, cfg: RenderConfig, seed, mesh: Mesh):
    """Full-frame radiance [H, W, 3] with rays sharded over the mesh: each
    shard's ids through `render_ids_chunked` on its device, the rows
    concatenated in shard order, trimmed to the frame, each pixel's
    samples averaged. On a mesh over several processes each renders only
    its shards and returns a `FramePart` (no communication in the forward
    pass); `multihost.gather_image` assembles it."""
    cfg = cfg.resolved()
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    _check_devices(mesh, cfg)
    per = _pad_ids(H * W * spp, mesh.n_shards)
    rows = _local_rows(scene, cfg, seed, mesh, per)
    if mesh.world > 1:
        return FramePart(rows, H, W, spp)
    return _frame(rows, H, W, spp)


def render_sharded(scene, cfg: RenderConfig, seed: int = 0,
                   mesh: Optional[Mesh] = None):
    """A sharded render over a given mesh, without autograd. With no mesh:
    every local GPU where the config renders on "cuda", the CPU (one
    shard) where it renders on "cpu" (`RenderConfig.device`)."""
    if mesh is None:
        mesh = make_mesh(["cpu"]) if cfg.device == "cpu" else make_mesh()
    with torch.no_grad():
        return render_radiance_sharded(scene, cfg, seed, mesh)


# ---------------------------------------------------------------------------
# Differentiable rendering: sharded loss + gradient all-reduce
# ---------------------------------------------------------------------------


def _local_loss(scene, cfg, seed, ids, target_rows, n_total):
    """Sum of squared error of this shard's rays against the target,
    normalized by the GLOBAL element count, so that the sum over shards is
    the per-sample mean loss of models/train.py `full_loss`. Padded
    out-of-frame rays are masked out."""
    radiance = render_ids_chunked(scene, cfg, seed, ids)
    live = (ids < n_total).to(radiance.dtype)[:, None]
    err = (radiance - target_rows) * live
    return torch.sum(err * err) / (n_total * 3.0)


def _target_rows(target, height, width, spp, n_rows):
    """The target value of each padded ray id [n_rows, 3]: each pixel's
    value repeated spp times in id order (a broadcast, not a gather);
    padding rows repeat the last pixel (masked out of the loss anyway)."""
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, np.float32))
    t2 = target.to(torch.float32).reshape(height * width, 3)
    rows = t2[:, None, :].expand(height * width, spp, 3).reshape(-1, 3)
    pad = n_rows - rows.shape[0]
    if pad:
        rows = torch.cat([rows, t2[-1:].expand(pad, 3)])
    return rows


def loss_and_grad_sharded(scene, cfg: RenderConfig, seed, target,
                          mesh: Mesh):
    """(loss, {leaf path: d loss / d leaf}) with rays sharded over the mesh
    and ONE all-reduce for the gradients and the loss.

    `target` is the [H, W, 3] target radiance; each supersample is
    compared with its pixel's value. The gradients are taken with respect
    to the scene leaves that require grad, or every leaf (as jax.grad)
    when none does; keyed by `leaf_items` path, each on its leaf's device.
    The loss is a 0-d tensor on the first device. Every rank of the
    mesh's group gets the same values."""
    cfg = cfg.resolved()
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    n_total = H * W * spp
    _check_devices(mesh, cfg)
    per = _pad_ids(n_total, mesh.n_shards)
    items = leaf_items(scene)
    if not any(t.requires_grad for _, t in items):
        scene = replace_leaves(scene, [t.detach().requires_grad_(True)
                                       for _, t in items])
        items = leaf_items(scene)
    wrt = [(name, t) for name, t in items if t.requires_grad]
    rows = _target_rows(target, H, W, spp, mesh.n_shards * per)
    first = mesh.devices[0]
    loss = None
    with torch.enable_grad():
        copies = replicate_scene(scene, mesh)
        for k, dev in mesh.local_shards():
            with _shard_device(dev):
                part = _local_loss(copies[dev], cfg, seed,
                                   _shard_ids(k, per, dev),
                                   rows[k * per:(k + 1) * per].to(dev),
                                   n_total).to(first)
            loss = part if loss is None else loss + part
        grads = torch.autograd.grad(loss, [t for _, t in wrt],
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for (_, t), g in zip(wrt, grads)]
    loss = loss.detach()
    if mesh.group is not None:
        # the one collective: every leaf's gradient and the loss, summed
        # over all ranks in one buffer
        flat = torch.cat([g.reshape(-1).to(first) for g in grads]
                         + [loss.reshape(1)])
        dist.all_reduce(flat, group=mesh.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.device))
            at += g.numel()
        grads, loss = out, flat[-1]
    return loss, {name: g for (name, _), g in zip(wrt, grads)}


# {device: the scene's resident copy there}, for frames without autograd
_RESIDENT: dict = {}


def replicate_scene(scene, mesh: Mesh) -> dict:
    """{device: the scene on it} for each distinct device of the mesh: the
    analog of the CUDA build's one-time scene upload, made once per frame
    or step rather than once per shard; on the scene's own device it is
    the scene itself. Under autograd (a leaf that needs a gradient) it is
    `scene.to(d)`, which is differentiable, so autograd sums the shards'
    gradients onto the caller's leaves. Otherwise each other device keeps
    one resident copy, into which every frame copies the scene's values
    while its layout stays: the copy's tensors keep their addresses, on
    which the wavefront's CUDA graphs are keyed (models/graphs.py)."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in scene.tensors())
    return {d: scene.to(d) if grad else _resident(scene, d)
            for d in dict.fromkeys(mesh.devices)}


def _resident(scene, dev: torch.device):
    """The scene on `dev`: itself where it is there, else `dev`'s resident
    copy with the scene's values copied in (a new copy where the layout
    differs)."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if all(t.device == dev for t in scene.tensors()):
        return scene
    copy = _RESIDENT.get(dev)
    with torch.no_grad():
        if copy is None or _layout(copy) != _layout(scene):
            copy = _RESIDENT[dev] = scene.to(dev)
        else:
            for dst, src in zip(copy.tensors(), scene.tensors()):
                dst.copy_(src)
    return copy


def _layout(obj) -> tuple:
    """A scene's layout: each tensor leaf's shape and dtype, and every
    other field's value, depth first."""
    out = []
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append((tuple(v.shape), v.dtype))
        elif is_dataclass(v):
            out.append(_layout(v))
        else:
            out.append(v)
    return tuple(out)

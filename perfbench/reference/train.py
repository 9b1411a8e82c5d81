"""The plain reference of a training step: the per-sample mean squared
error of the rendered radiance against a target frame, its gradient by
autograd through `render.radiance` (in blocks of samples, summed), and
Adam with torch's conventions (bias corrections, eps outside the root),
written out here."""

from __future__ import annotations

import torch

from perfbench.reference.render import Config, radiance, render_ids

B1, B2, EPS = 0.9, 0.999, 1e-8
MASK32 = 0xFFFFFFFF


def target_frame(scene, cfg: Config, seed, dtype=torch.float32,
                 device="cpu"):
    """[H, W, 3]: the whole frame at `seed`, samples averaged."""
    n = cfg.width * cfg.height * cfg.spp
    with torch.no_grad():
        ids = torch.arange(n, device=device)
        rad = render_ids(scene, cfg, seed, ids, dtype)
    return rad.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2)


def loss_and_grads(scene, cfg: Config, seed, target, names, dtype,
                   block=1 << 14):
    """(loss, {name: gradient}) of the per-sample squared error against
    `target` [H, W, 3] over every sample of the frame, with respect to
    the leaves `names`."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.leaves() if k in names}
    sc = scene.with_leaves(leaves)
    n = cfg.width * cfg.height * cfg.spp
    flat = target.reshape(-1, 3).to(dtype)
    dev = target.device
    total = 0.0
    for i in range(0, n, block):
        ids = torch.arange(i, min(i + block, n), device=dev)
        err = radiance(sc, cfg, seed, ids, dtype) - flat[ids // cfg.spp]
        part = (err * err).sum() / (n * 3)
        part.backward()
        total += float(part.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaves.items()}


class Adam:
    """Adam over named tensors: lr, betas (0.9, 0.999), eps 1e-8."""

    def __init__(self, params: dict, lr: float):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.t = lr, 0

    def step(self, grads: dict):
        self.t += 1
        bc1, bc2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for k, g in grads.items():
            self.m[k] = B1 * self.m[k] + (1 - B1) * g
            self.v[k] = B2 * self.v[k] + (1 - B2) * g * g
            denom = self.v[k].sqrt() / bc2 ** 0.5 + EPS
            self.p[k] = self.p[k] - (self.lr / bc1) * self.m[k] / denom


def follow(scene, cfg: Config, key, target, names, lr, steps, dtype):
    """The reference's first `steps` training steps from `scene`, step i
    drawn at key + i: (losses, first gradients, leaves after the last
    step), each by leaf name."""
    opt = Adam({k: v for k, v in scene.leaves() if k in names}, lr)
    losses, first = [], None
    for i in range(steps):
        loss, grads = loss_and_grads(scene.with_leaves(opt.p), cfg,
                                     (int(key) + i) & MASK32, target, names,
                                     dtype)
        if first is None:
            first = grads
        opt.step(grads)
        losses.append(loss)
    return losses, first, opt.p

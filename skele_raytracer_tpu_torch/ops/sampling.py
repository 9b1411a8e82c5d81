"""Counter-based random sampling and hemisphere utilities.

The reference draws from shared-state libc `rand()` inside its OpenMP
region (src/main.cpp:52, src/raytrace.h:119-120), a data race. As in the
JAX package (`skele_raytracer_tpu.ops.sampling`), every draw here comes
from an explicit counter-based threefry2x32: the key encodes (seed,
bounce, purpose) and the counter is (ray_id, draw_index), so a frame is
the same under any chunking or device split, and the streams are bit for
bit those of the JAX package and of the CUDA kernel
(csrc/frame_math.cuh `draw2`). No `torch.Generator` is involved.

torch has no add and no shifts on uint32 CPU tensors, so the generator
computes on int64 tensors holding values in [0, 2^32), masked after each
add and shift (a 32-bit rotate of such a value fits in 61 bits). Key and
counter words given as Python ints stay scalars of the tensor ops (no
tensor is built from them, so no host-to-device copy). The seed may also
be an int64 tensor (a 0-d device tensor: the static input of a chunk's
CUDA graph, models/graphs.py), whose key word then flows on the device;
the draws are the same bits either way. On CUDA tensors `uniform` runs as
one kernel (ops/cuda/glue.py), which gives these ops' bits; they stay the
path on every other device and the kernel's oracle (`uniform_torch`).
"""

from __future__ import annotations

import numpy as np
import torch

from skele_raytracer_tpu_torch.config import Quirks
from skele_raytracer_tpu_torch.ops.cuda import glue
from skele_raytracer_tpu_torch.ops.geometry import cross

# Purpose tags for independent streams per (ray, bounce).
PURPOSE_JITTER = 0  # supersampling pixel jitter (src/main.cpp:52)
PURPOSE_PATH = 1  # MC hemisphere r1, r2 (src/raytrace.h:119-120)
PURPOSE_FOG = 2  # fog interaction + phase function (src/blinn_phong.h:30)

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_GOLDEN = 0x9E3779B9
_TWO_PI = float(np.float32(2.0 * np.pi))


def _u32(v, like: torch.Tensor):
    """A uint32 value: a tensor as an int64 tensor on like's device, an int
    (or numpy integer) as a Python int, each masked to 32 bits."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.int64) & _MASK
    return int(v) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1):
    """Threefry-2x32, 20 rounds (the algorithm jax.random uses).

    k0, k1: uint32 key words (ints or tensors broadcastable to x0).
    x0, x1: uint32 counter words; x0 a tensor, x1 an int or a tensor.
    Returns (y0, y1) as int64 tensors holding the uint32 words.
    """
    k0, k1, x1 = _u32(k0, x0), _u32(k1, x0), _u32(x1, x0)
    x0 = x0.to(torch.int64) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _MASK

    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        rots = _ROT_A if g % 2 == 0 else _ROT_B
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _MASK
    return x0, x1


def _stream_key_words(seed, bounce, purpose):
    """(k0, k1) uint32 key words for the (seed, bounce, purpose) stream:
    k0 the seed's (an int, or an int64 tensor as it is: `threefry2x32`
    masks it), k1 an int."""
    k0 = seed if isinstance(seed, torch.Tensor) else int(seed) & _MASK
    k1 = (int(bounce) * _GOLDEN + int(purpose)) & _MASK
    return k0, k1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1): top 24 bits scaled by 2^-24."""
    return (bits >> 8).to(torch.float32) * float(2**-24)


def uniform(seed, ray_id: torch.Tensor, bounce, purpose, shape=()):
    """U[0,1) draws, shape [len(ray_id), *shape]. `seed`: an int, or a 0-d
    int64 tensor on ray_id's device (the same draws).

    Draw i comes from word i%2 of threefry counter (ray_id, i//2), the
    JAX package's two-word mapping (ops/sampling.py:80-106 there). On CUDA
    tensors one kernel draws them (ops/cuda/glue.py `uniform_kernel`),
    elsewhere the int64 tensor ops of `uniform_torch`: the same bits.
    """
    if ray_id.device.type == "cuda":
        return glue.uniform_kernel(seed, ray_id, bounce, purpose, shape)
    return uniform_torch(seed, ray_id, bounce, purpose, shape)


def uniform_torch(seed, ray_id: torch.Tensor, bounce, purpose, shape=()):
    """`uniform` in int64 tensor ops on any device: the plain version of
    the draw kernel."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    m = (n + 1) // 2
    k0, k1 = _stream_key_words(seed, bounce, purpose)
    R = ray_id.shape[0]
    x0 = ray_id.to(torch.int64)[:, None].expand(R, m)
    x1 = torch.arange(m, dtype=torch.int64, device=ray_id.device)[None, :]
    y0, y1 = threefry2x32(k0, k1, x0, x1.expand(R, m))
    u = torch.stack([bits_to_unit(y0), bits_to_unit(y1)], dim=-1)
    return u.reshape(R, 2 * m)[:, :n].reshape((R,) + tuple(shape))


def uniform_sample_hemi(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Hemisphere sample in tangent space, y-up (reference
    `uniform_sample_hemi`, src/raytrace.h:22-30): NOT cosine-weighted.
    r1, r2: [...]; returns [..., 3]."""
    pos = 1.0 - r1 * r1 > 0
    s_theta = torch.sqrt(torch.where(pos, 1.0 - r1 * r1, 1.0)) * pos
    phi = _TWO_PI * r2
    return torch.stack(
        [s_theta * torch.cos(phi), r1, s_theta * torch.sin(phi)], dim=-1)


def tangent_frame(normal: torch.Tensor, use_x=None):
    """Orthogonal-ish frame around `normal` (reference
    `transform_coordinate_space`, src/utils.h:148-165). Returns
    (perp_to_normal, perp_to_both), each [..., 3]. `use_x` ([...] bool)
    optionally freezes the |nx| > |ny| branch (the fixed-topology
    finite-difference check of the replay)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    if use_x is None:
        use_x = torch.abs(nx) > torch.abs(ny)
    inv_a = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=1e-30))
    inv_b = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=1e-30))
    zero = torch.zeros_like(nx)
    pn = torch.stack([
        torch.where(use_x, nz * inv_a, zero),
        torch.where(use_x, zero, -nz * inv_b),
        torch.where(use_x, -nx * inv_a, ny * inv_b),
    ], dim=-1)
    return pn, cross(normal, pn)


def to_world(sample: torch.Tensor, normal: torch.Tensor, *, quirks: Quirks,
             use_x=None):
    """Tangent-space sample -> world space. Parity replicates the
    reference's skewed transform (src/raytrace.h:123-125): the third basis
    column mixes perp_to_normal.x with perp_to_both.{y,z}. `use_x`: see
    tangent_frame."""
    pn, pb = tangent_frame(normal, use_x)
    sx, sy, sz = sample[..., 0:1], sample[..., 1:2], sample[..., 2:3]
    if quirks.buggy_tangent_frame:
        third = torch.stack([pn[..., 0], pb[..., 1], pb[..., 2]], dim=-1)
        return sx * pb + sy * normal + sz * third
    return sx * pb + sy * normal + sz * pn


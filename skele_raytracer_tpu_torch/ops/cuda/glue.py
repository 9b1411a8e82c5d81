"""The wavefront glue's integer chains as hand-written kernels: the ray
sort keys and the threefry draws, one launch each (csrc/glue.cu).

On CUDA tensors, `culled._sort_rays` and `megakernel.sort_rays` take their
keys from `sort_keys_kernel`, and `sampling.uniform` its draws from
`uniform_kernel`. On CPU tensors the int64 tensor code there runs as
before: it is the plain version of each kernel and the tests' oracle
(`culled.footprint_keys_torch`, `megakernel.spatial_keys_torch`,
`sampling.uniform_torch`), and each kernel gives its bits exactly (the
per-ray math is csrc/glue_math.cuh, which the CPU tests build for the host).
The stable `torch.sort` of the keys and the gather of `live` stay with the
callers.

Each wrapper launches on the current stream, so a chunk's CUDA graph
(models/graphs.py) captures it; `uniform_kernel` reads a tensor seed from
the device when the kernel runs, so a replay with a new seed in the
graph's static seed draws the new stream. Launches are counted in
LAUNCHES.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from skele_raytracer_tpu_torch.ops.cuda._build import check_outputs
from skele_raytracer_tpu_torch.utils import profiling

KEY_FOOTPRINT, KEY_SPATIAL = 0, 1  # csrc/glue_math.cuh key modes
_MASK = 0xFFFFFFFF

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"sort_keys": 0, "uniform": 0}
profiling.COUNTERS["launches"]["glue"] = LAUNCHES

_lib = None


def bind(lib):
    """Declares `glue_sort_keys` and `glue_uniform` of a loaded library."""
    lib.glue_sort_keys.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 6)
    lib.glue_uniform.argtypes = (
        [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_uint] * 3 + [ctypes.c_void_p] * 2)
    for f in (lib.glue_sort_keys, lib.glue_uniform):
        f.restype = ctypes.c_int
    return lib


def build_kernel():
    """Build (if needed) and load the CUDA kernel library."""
    global _lib
    if _lib is None:
        from skele_raytracer_tpu_torch.ops.cuda._build import load_cuda

        _lib = bind(load_cuda("glue"))
    return _lib


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def sort_keys_kernel(o, d, table, live=None, *, mode: int,
                     allow_negative: bool = False):
    """[R] int64 sort keys of rays o, d [R, 3] (float32, any strides) on
    the card: KEY_FOOTPRINT, `culled.footprint_keys_torch`'s, or
    KEY_SPATIAL, `megakernel.spatial_keys_torch`'s, over `table`
    (`ClusteredMesh.sort_table`: the supercluster boxes, then the mesh
    box); `live` [R] float32 or None. Counted in LAUNCHES["sort_keys"]."""
    dev = o.device
    R = o.shape[0]
    n_sc = (table.shape[0] - 6) // 6
    if dev.type != "cuda":
        raise ValueError(f"sort_keys kernel: CUDA tensors, got {dev}")
    if live is not None:
        live = live.contiguous()
    for x, shape in ((o, (R, 3)), (d, (R, 3)), (table, (6 * n_sc + 6,)),
                     (live, (R,))):
        if x is None:
            continue
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"sort_keys kernel: float32 operands on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"sort_keys kernel: operand {shape}, got "
                             f"{tuple(x.shape)}")
    if not table.is_contiguous():
        raise ValueError("sort_keys kernel: a contiguous table")
    if R >= 2**31:
        raise ValueError("sort_keys kernel: fewer than 2^31 rays")
    keys = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return keys
    lib = build_kernel()
    with torch.cuda.device(dev):
        err = lib.glue_sort_keys(
            R, mode, n_sc, int(allow_negative), *o.stride(), *d.stride(),
            o.data_ptr(), d.data_ptr(),
            None if live is None else live.data_ptr(), table.data_ptr(),
            keys.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"sort_keys kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["sort_keys"] += 1
    check_outputs("sort_keys", keys)
    return keys


def uniform_kernel(seed, ray_id, bounce, purpose, shape=()):
    """`sampling.uniform` on the card in one launch: [R, *shape] float32
    draws for ray_id [R] (int64 or int32). `seed`: an int, or a 0-d
    integer tensor, moved to ray_id's device as int64 where it is not
    there (the twin's `_u32` does the same) and read there when the kernel
    runs, never copied to the host. Counted in LAUNCHES["uniform"]."""
    dev = ray_id.device
    if dev.type != "cuda":
        raise ValueError(f"uniform kernel: CUDA tensors, got {dev}")
    if ray_id.dim() != 1 or ray_id.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"uniform kernel: ray_id [R] int64 or int32, got "
                         f"{ray_id.dtype} {tuple(ray_id.shape)}")
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    R = ray_id.shape[0]
    out = torch.empty((R, n), dtype=torch.float32, device=dev)
    seed_dev, seed_int = None, 0
    if isinstance(seed, torch.Tensor):
        seed_dev = seed.to(device=dev, dtype=torch.int64).reshape(())
    else:
        seed_int = int(seed) & _MASK
    if R == 0 or n == 0:
        return out.reshape((R,) + tuple(shape))
    ids = ray_id.contiguous()
    lib = build_kernel()
    with torch.cuda.device(dev):
        err = lib.glue_uniform(
            R, n, int(ids.dtype == torch.int64), ids.data_ptr(),
            None if seed_dev is None else seed_dev.data_ptr(), seed_int,
            int(bounce) & _MASK, int(purpose) & _MASK, out.data_ptr(),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"uniform kernel launch failed: CUDA error {err}")
    LAUNCHES["uniform"] += 1
    check_outputs("uniform", out)
    return out.reshape((R,) + tuple(shape))

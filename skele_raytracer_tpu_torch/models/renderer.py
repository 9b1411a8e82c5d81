"""Top-level render orchestration (the JAX package's models/renderer.py).

Rays are generated from flat sample ids (pixel * spp + sample), which
double as the RNG counter, so any partition of the id space renders the
same frame. Supersamples are averaged per pixel (image[y][x] /= grid^2,
reference src/main.cpp:68) into [H, W, 3].

Two paths, chosen as in the JAX package (`render_ids_chunked`):

* small scenes (spheres and at most 32 decorative triangles) go to the
  whole-frame path tracer, ops/cuda/pathtrace.py (kernel K1). On the card
  without autograd a frame replays a CUDA graph of its whole K1 render
  (models/graphs.py: the tables, the sample planes, K1 and the stack),
  keyed on the scene, the config and the ids' length: every whole frame,
  every equal band of a progressive frame and every card's shard of a
  sharded one; a new key (a cut last band the first time), autograd
  (training), CPU tensors and debug output checks run eagerly;
* everything else (meshes of any size, larger sphere sets, more fog
  volumes) streams through the chunked wavefront: chunks of
  `_chunk_samples` ids -> camera rays -> models/integrator.py, whose
  triangle scans go to the culled kernels K3/K4 and the brute-force kernel
  K5, or, with `RenderConfig.fused_megakernel` on a clean mesh scene, to
  the fused kernel K7 (one launch per wave). On the card without
  autograd each full chunk replays a CUDA graph of the whole chunk
  (models/graphs.py); otherwise the loop is eager, chunk by chunk. The
  last chunk is cut, not padded, and a cut chunk runs eagerly.

Backend "cuda" runs the hand-written kernels on the GPU; "torch" runs
their plain PyTorch versions on the CPU. `render_radiance` (and the
training loss, models/train.py) is differentiable in the scene's leaves
on both paths: the whole-frame path through its backward kernel K2, the
wavefront through eager autograd with per-chunk recompute. `render` and
`render_frames` run under `torch.no_grad()`. Clean non-MC frames go
through the wavefront's Whitted frontier (integrator.py
`integrate_whitted`); the K1 gate never takes them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from skele_raytracer_tpu_torch.config import RenderConfig
from skele_raytracer_tpu_torch.models import graphs
from skele_raytracer_tpu_torch.models.integrator import integrate
from skele_raytracer_tpu_torch.ops.camera import rays_for_ids
from skele_raytracer_tpu_torch.ops.cuda import pathtrace
from skele_raytracer_tpu_torch.scene.types import with_live_normals
from skele_raytracer_tpu_torch.utils import profiling


def _chunk_samples(cfg: RenderConfig) -> int:
    """Samples per chunk such that the expanded in-flight ray set stays
    near cfg.rays_per_chunk (Monte-Carlo expands each sample into
    num_paths paths; the Whitted frontier doubles per depth level)."""
    if cfg.monte_carlo:
        fan = max(cfg.paths_per_sample, 1)
    elif cfg.quirks.disable_reflections:
        fan = 1
    else:
        fan = 2 ** min(max(cfg.max_depth - 1, 0), 12)
    per = max(1, cfg.rays_per_chunk // fan)
    return max(128, min(per, cfg.height * cfg.width * cfg.samples_per_pixel))


def render_ids(scene, cfg: RenderConfig, seed, sample_ids):
    """Radiance [N, 3] of one chunk of flat sample ids."""
    o, d = rays_for_ids(scene.camera, cfg, seed, sample_ids)
    return integrate(scene, cfg, seed, o, d, sample_ids)


def _needs_grad(scene) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in scene.tensors())


def render_ids_wavefront(scene, cfg: RenderConfig, seed, sample_ids):
    """Radiance [N, 3] through the chunked wavefront, chunk by chunk.
    On the card without autograd, a full chunk replays its CUDA graph
    (models/graphs.py: captured on the first chunk of its shape, the same
    kernels in the same order). Under autograd each chunk is recomputed in
    the backward pass (`torch.utils.checkpoint`, as `jax.checkpoint` in the
    JAX package's render_ids_chunked_jnp), so a frame holds one chunk's
    intermediates at a time. The RNG is counter-based and the kernels are
    deterministic (K7's per-ray answers depend on neither the ray order
    nor the tiling, and it saves its own hit structure for the replay), so
    the recompute sees the same hits."""
    chunk = _chunk_samples(cfg)
    grad = _needs_grad(scene)
    key = None
    out = []
    for i in range(0, sample_ids.shape[0], chunk):
        ids = sample_ids[i:i + chunk]
        with profiling.span("chunk"):
            if graphs.replays(ids.device, grad, ids.shape[0], chunk):
                if key is None:
                    key = graphs.ChunkGraphs.key(scene, cfg, ids)
                out.append(graphs.CHUNK_GRAPHS.run(
                    graphs.CHUNK, render_ids, key, scene, cfg, seed, ids))
                continue
            graphs.COUNTS["eager"] += 1
            if grad:
                out.append(checkpoint(render_ids, scene, cfg, seed, ids,
                                      use_reentrant=False))
            else:
                out.append(render_ids(scene, cfg, seed, ids))
    return torch.cat(out)


def render_ids_k1(scene, cfg: RenderConfig, seed, sample_ids):
    """Radiance [N, 3] through the whole-frame kernel K1
    (`pathtrace.pathtrace_ids`). On the card without autograd it replays
    the CUDA graph of the frame's scene, config and length
    (models/graphs.py: a new key runs eagerly, then captures); otherwise
    it runs eagerly. The card's frames count in COUNTERS["frame.graph"]."""
    dev = sample_ids.device
    if graphs.replays(dev, _needs_grad(scene), sample_ids.shape[0]):
        key = graphs.ChunkGraphs.frame_key(scene, cfg, sample_ids)
        return graphs.CHUNK_GRAPHS.run(graphs.FRAME, pathtrace.pathtrace_ids,
                                       key, scene, cfg, seed, sample_ids)
    if dev.type == "cuda":
        graphs.FRAME.counts["eager"] += 1
    return pathtrace.pathtrace_ids(scene, cfg, seed, sample_ids)


def render_ids_chunked(scene, cfg: RenderConfig, seed, sample_ids):
    """Radiance [N, 3] for arbitrary flat sample ids, on the device of the
    resolved backend (scene and ids are moved there): the ids' card when
    they lie on one, else the current card; differentiable in the scene's
    leaves (the JAX package's render_ids_chunked)."""
    cfg = cfg.resolved()
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and sample_ids.is_cuda:
        dev = sample_ids.device  # a shard's own card (parallel/api.py)
    if any(t.device != dev for t in scene.tensors()):
        scene = scene.to(dev)  # a scene held there already stays as it is
    sample_ids = sample_ids.to(dev)
    if scene.has_triangles and _needs_grad(scene.triangles):
        scene = with_live_normals(scene)
    if pathtrace.use_pathtrace(scene, cfg):
        return render_ids_k1(scene, cfg, seed, sample_ids)
    return render_ids_wavefront(scene, cfg, seed, sample_ids)


@profiling.spanned("render")
def render_radiance(scene, cfg: RenderConfig, seed):
    """Full-frame radiance [H, W, 3] float32 (pre-quantization); a frame
    is the span `render` (utils/profiling.py)."""
    cfg = cfg.resolved()
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    sample_ids = torch.arange(H * W * spp, dtype=torch.int64,
                              device=cfg.device)
    radiance = render_ids_chunked(scene, cfg, seed, sample_ids)
    return radiance.reshape(H, W, spp, 3).mean(dim=2)


def render(scene, cfg: RenderConfig, seed: int = 0):
    """Render a frame: [H, W, 3] float32 radiance on the backend's device
    (quantize with utils.image.quantize / write_ppm after `.cpu()`)."""
    with torch.no_grad():
        return render_radiance(scene, cfg, seed)


def render_frames(scene, cfg: RenderConfig, seeds):
    """Render a batch of frames with distinct RNG seeds: [K, H, W, 3]."""
    with torch.no_grad():
        return torch.stack([render_radiance(scene, cfg, int(s))
                            for s in seeds])

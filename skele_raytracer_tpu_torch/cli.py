"""Command-line entry point: the reference CLI's surface on PyTorch/CUDA.

The flags are those of the JAX package's CLI (`skele_raytracer_tpu.cli`),
itself the reference's (src/main.cpp:230-413) plus `--mode`, `--seed`,
`--frames` and `--spp-accumulate`. `--backend` takes cuda|torch|auto:
the hand-written CUDA kernels on the GPU (the default; without a visible
GPU the run exits 1 naming --backend torch), their plain PyTorch versions
on the CPU, or auto (cuda when a GPU is visible, else torch).

  --mode clean          without --gillum: the Whitted integrator
                        (reflection, refraction, Fresnel)
  --progressive         render in restartable row bands
                        (models/progressive.py), implied by --resume and
                        --preview-dir; --band-rows sets the band height
  --profile DIR         write a torch.profiler trace of the run to
                        DIR/trace.json (utils/profiling.py): the
                        program's stages above its ops and kernels
  --mesh                the default: with more than one visible GPU, a
                        frame's rays are sharded over all of them
                        (parallel/api.py `render_sharded`); with one GPU,
                        or on the CPU, the frame renders as with --no-mesh
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from skele_raytracer_tpu_torch.config import BACKENDS, CLEAN, PARITY, RenderConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="skele-raytracer-tpu-torch",
        description="PyTorch/CUDA ray tracer "
        "(capabilities of lilinitsy/skele-raytracer)",
    )
    p.add_argument("--path", required=True, help="scene .scn file")
    p.add_argument("--output", required=True, help="output image (.ppm/.png)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--gillum", type=int, default=None, metavar="N",
                   help="enable Monte-Carlo GI with N paths per sample")
    p.add_argument("--jsample", type=int, default=0, metavar="N",
                   help="N x N jittered supersampling grid")
    p.add_argument("--depth", type=int, default=3, help="max trace depth")
    p.add_argument("--parallel", default="true", choices=("true", "false"),
                   help="accepted for reference compatibility (no-op)")
    p.add_argument("--shadow", action="store_true", help="enable shadow rays")
    p.add_argument("--mode", default="parity", choices=("parity", "clean"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", dest="mesh", action="store_true", default=True,
                   help="shard a frame's rays over all visible GPUs "
                   "(default; one GPU or the CPU renders unsharded)")
    p.add_argument("--no-mesh", dest="mesh", action="store_false")
    p.add_argument("--chunk", type=int, default=1 << 16,
                   help="ray-batch chunk size of the chunked integrator")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                   "DIR/trace.json: the program's stages (frame, chunk, "
                   "wave, sort, K1's tables and planes, each kernel "
                   "wrapper) above its ops and kernels")
    p.add_argument("--backend", default="cuda", choices=BACKENDS,
                   help="cuda (default): hand-written CUDA kernels on the "
                   "GPU, an error without one; torch: their plain PyTorch "
                   "versions on the CPU; auto: cuda when a GPU is visible, "
                   "else torch")
    p.add_argument("--frames", type=int, default=None, metavar="K",
                   help="render K frames (seeds seed..seed+K-1); "
                   "--output out.ppm writes out_000.ppm..")
    p.add_argument("--spp-accumulate", type=int, default=None, metavar="K",
                   help="average K independently-seeded frames into one "
                   "K-times-denoised image")
    p.add_argument("--progressive", action="store_true",
                   help="render in restartable row bands "
                   "(models/progressive.py); implied by --resume/--preview-dir")
    p.add_argument("--band-rows", type=int, default=64, metavar="N",
                   help="rows per progressive band (default 64)")
    p.add_argument("--resume", default=None, metavar="STATE",
                   help=".npz crash-resume state file: finished bands "
                   "persist there and a rerun continues after the last one")
    p.add_argument("--preview-dir", default=None, metavar="DIR",
                   help="overwrite DIR/preview.ppm with the partial frame "
                   "after each band")
    return p


def config_from_args(args, scene_width: int, scene_height: int) -> RenderConfig:
    """CLI > scene file > defaults (the scene file wins unless the flag
    was actually passed)."""
    return RenderConfig(
        width=args.width if args.width is not None else scene_width,
        height=args.height if args.height is not None else scene_height,
        fov=args.fov,
        max_depth=args.depth,
        grid_size=args.jsample,
        monte_carlo=args.gillum is not None,
        num_paths=args.gillum if args.gillum is not None else 1,
        use_shadows=args.shadow,
        quirks=PARITY if args.mode == "parity" else CLEAN,
        rays_per_chunk=args.chunk,
        backend=args.backend,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from skele_raytracer_tpu_torch.models.renderer import render, render_frames
    from skele_raytracer_tpu_torch.scene.parser import parse_scene
    from skele_raytracer_tpu_torch.utils.image import quantize, write_ppm
    from skele_raytracer_tpu_torch.utils.profiling import profiler_trace, sync

    try:
        parsed = parse_scene(args.path)
    except FileNotFoundError:
        # The reference exits with a message on a missing scene file
        # (reference src/scene.cpp:22-26); exit nonzero here.
        print(f"scene file could not be opened: {args.path}", file=sys.stderr)
        return 1
    try:
        cfg = config_from_args(args, parsed.width, parsed.height).resolved()
    except RuntimeError as e:  # the default backend and no GPU
        print(e, file=sys.stderr)
        return 1
    n_dev = torch.cuda.device_count() if cfg.backend == "cuda" else 1
    progressive = args.progressive or args.resume or args.preview_dir
    if (args.frames or args.spp_accumulate) and progressive:
        print("--frames/--spp-accumulate cannot combine with progressive "
              "rendering", file=sys.stderr)
        return 2
    scene = parsed.to_scene(cfg.quirks, device=cfg.device)
    device_name = (torch.cuda.get_device_name(0) if cfg.backend == "cuda"
                   else "cpu")
    print(f"{cfg!r}\ndevice: {device_name}", file=sys.stderr)

    def run():
        if args.frames or args.spp_accumulate:
            k = args.frames or args.spp_accumulate
            frames = render_frames(scene, cfg, range(args.seed, args.seed + k))
            return frames.mean(dim=0) if args.spp_accumulate else frames
        if progressive:
            from skele_raytracer_tpu_torch.models.progressive import (
                render_progressive,
            )

            preview_cb = None
            if args.preview_dir:
                os.makedirs(args.preview_dir, exist_ok=True)
                path = os.path.join(args.preview_dir, "preview.ppm")

                def preview_cb(frame, rows_done):
                    tmp = path + ".tmp"
                    write_ppm(tmp, frame)
                    os.replace(tmp, path)

            return render_progressive(
                scene, cfg, seed=args.seed, band_rows=args.band_rows,
                state_path=args.resume, preview_cb=preview_cb)
        if args.mesh and n_dev > 1:
            from skele_raytracer_tpu_torch.parallel import (
                make_mesh,
                render_sharded,
            )

            return render_sharded(scene, cfg, seed=args.seed,
                                  mesh=make_mesh())
        return render(scene, cfg, seed=args.seed)

    t0 = time.perf_counter()
    with profiler_trace(args.profile):
        img = run()
        sync(img)
    dt = time.perf_counter() - t0
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()

    n_frames = args.frames or args.spp_accumulate or 1
    rays = cfg.width * cfg.height * cfg.samples_per_pixel * n_frames
    print(
        f"rendered {n_frames} x {cfg.width}x{cfg.height} ({rays} primary "
        f"rays) in {dt:.3f}s [{rays / dt:,.0f} rays/s incl. kernel build]",
        file=sys.stderr,
    )

    def write_one(path, frame):
        if path.endswith(".png"):
            try:
                from PIL import Image
            except ImportError:
                ppm = path[:-4] + ".ppm"
                print(f"PIL unavailable; writing {ppm}", file=sys.stderr)
                write_ppm(ppm, frame)
                return ppm
            Image.fromarray(quantize(frame)).save(path)
        else:
            write_ppm(path, frame)
        return path

    if args.frames:
        root, ext = os.path.splitext(args.output)
        for k in range(args.frames):
            write_one(f"{root}_{k:03d}{ext}", img[k])
        print(f"WROTE TO {root}_000{ext} .. {root}_{args.frames - 1:03d}{ext}",
              file=sys.stderr)
    else:
        write_one(args.output, img)
        print(f"WROTE TO {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time-only probes of the culled bounce-wave kernel on the card (the
counterpart of the JAX package's tools/lab_probe.py): L4 (`lab_probe`)
splits a tile's cost into control (the loop and its exit), product and
epilogue by timing reduced kernels that are wrong on purpose: `full1` runs
one group with no loop, `mm` the product and a cheap minimum, `loop` the
whole walk (equal to `lab_base` with gate_settle off). The `loop` rows take
the split walk, as `lab_base` does (three kernels per call, beside the same
kernel at one item per tile); the `full1` and `mm` rows stream one group
per tile through a persistent grid (one kernel per call). The `mm` rows
also print `torch.matmul`'s time for the same product, [R, 16] x
[16, 4 cs group_c] in FP32 (TF32 off) and in bf16, as their library
yardstick.

    python -m skele_raytracer_tpu_torch.tools.lab_probe [row ...] \\
        [--device cpu] [--samples N]
    python -m skele_raytracer_tpu_torch.tools.lab_probe loop_g2_p3 mm_g2_p3
"""

import sys

import torch

from skele_raytracer_tpu_torch.tools import kernel_lab as kl

# The TPU file's rows (tools/lab_probe.py main :157-179).
ROWS = {
    "loop_g2_p6 (prod-like)": ("lab_probe", dict(group_c=2, passes=6,
                                                 stage="loop")),
    "loop_g2_p3": ("lab_probe", dict(group_c=2, passes=3, stage="loop")),
    "full1_g2_p6 (no loop)": ("lab_probe", dict(group_c=2, passes=6,
                                                stage="full1")),
    "full1_g2_p3": ("lab_probe", dict(group_c=2, passes=3, stage="full1")),
    "mm_g2_p6 (matmul only)": ("lab_probe", dict(group_c=2, passes=6,
                                                 stage="mm")),
    "mm_g2_p3": ("lab_probe", dict(group_c=2, passes=3, stage="mm")),
    "full1_g1_p3 (1 cluster)": ("lab_probe", dict(group_c=1, passes=3,
                                                  stage="full1")),
    "mm_g1_p3": ("lab_probe", dict(group_c=1, passes=3, stage="mm")),
}


def matmul_ms(R: int, width: int, dtype, device="cuda") -> float:
    """Device ms of torch.matmul of [R, 16] by [16, width] in `dtype` (the
    slope of 8 against 40 calls; FP32 with TF32 off)."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(R, 16, generator=g, device=device).to(dtype)
    w = torch.randn(16, width, generator=g, device=device).to(dtype)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return kl.slope_ms(lambda: torch.matmul(a, w))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def print_matmul(res, b, prefix="  "):
    """After an `mm` row on the card: torch.matmul's time for its product
    (kept in res["library_ms"])."""
    if res["stage"] != "mm" or b.feats.device.type != "cuda":
        return
    width = 4 * b.cluster_size * res["kw"]["group_c"]
    R = b.feats.shape[0]
    res["library_ms"] = {str(dt).split(".")[1]: matmul_ms(R, width, dt)
                         for dt in (torch.float32, torch.bfloat16)}
    print(f"{prefix}torch.matmul [{R}, 16] x [16, {width}]: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in
                      res["library_ms"].items()))


def main(argv=None):
    args = kl.parse(argv, __doc__.split("\n\n")[0])
    kl.run_rows(ROWS, args.rows, args.device, args.samples, "K3 (reference)",
                extra=print_matmul)
    return 0


if __name__ == "__main__":
    sys.exit(main())

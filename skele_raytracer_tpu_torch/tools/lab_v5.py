"""Lab variants v5 and v6 of the culled nearest kernel on the card (the
counterpart of the JAX package's tools/lab_v5.py): the folded blocks (a
constant 1 feature carries -kof into the t plane; masked triangles are
all-zero columns), the split control path (tiles whose shortlist fits in
one group take one straight group with no settle), the per-plane product
(L1, `lab_v6`, with `per_group`) and group_c / passes, each row held
against the production K3 on kernel_lab.py's dragon bounce batch.

Both kernels take the split walk of kernel_lab.py's L3 (ops/cuda/lab.py
`split_walk`): each tile's groups cut into work items of at most
lab.ITEM_GROUPS groups, taken by a persistent grid, each ray's best merged
by a 64-bit atomicMin; the split control path makes a tile whose shortlist
fits in one group one item of one group. So each row's time per call is the
sum of three kernels, beside the same kernel at one item per tile.

    python -m skele_raytracer_tpu_torch.tools.lab_v5 [row ...] \\
        [--device cpu] [--samples N]
"""

import sys

from skele_raytracer_tpu_torch.tools import kernel_lab as kl

# The TPU file's rows (tools/lab_v5.py main :354-377), the baseline
# (prod_g2) being K3.
ROWS = {
    "v5_g2_p3": ("lab_v5", dict(group_c=2, passes=3)),
    "v6_g2_p3 (per-plane)": ("lab_v6", dict(group_c=2, passes=3)),
    "v6_g2_p3_pergroup": ("lab_v6", dict(group_c=2, passes=3,
                                         per_group=True)),
    "v6_g2_p6 (per-plane)": ("lab_v6", dict(group_c=2, passes=6)),
    "v6_g4_p3 (per-plane)": ("lab_v6", dict(group_c=4, passes=3)),
}


def main(argv=None):
    args = kl.parse(argv, __doc__.split("\n\n")[0])
    kl.run_rows(ROWS, args.rows, args.device, args.samples,
                "prod_g2 (baseline, K3)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

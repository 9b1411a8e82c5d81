"""live_ray_share.mesh: the share of the rays of the nearest-hit walks
that are live, in %: Σ live ÷ Σ rays of K7 on the fused route, else of K3,
over the traced window (the program's device counters, counted by each
block of the kernels)."""

from perfbench import spans


def read(run):
    totals = spans.walk_totals()
    if not totals:
        return None
    kernel = "k7" if totals["k7"]["rays"] else "k3"
    return spans.walk_ratio(kernel, "live", "rays", 100.0)

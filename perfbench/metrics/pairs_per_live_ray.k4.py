"""pairs_per_live_ray.k4: (ray, cluster) pairs per live ray of K4's
shadow-ray walks: Σ pairs ÷ Σ live rays over the traced window. A block
counts n x its live rays, n the length of its shortlist (the program's
device counters; csrc/cluster_walk.cuh count_walk)."""

from perfbench import spans


def read(run):
    return spans.walk_ratio("k4", "pairs", "live")

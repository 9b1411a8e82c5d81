"""pairs_per_live_ray.k7: (ray, cluster) pairs per live ray of K7's
walks, its primary walk and each light's shadow walk: Σ pairs ÷ Σ live
rays over the traced window. A block counts n x the rays that walk, n the
length of its shortlist (the program's device counters;
csrc/cluster_walk.cuh count_walk, csrc/megakernel.cu)."""

from perfbench import spans


def read(run):
    return spans.walk_ratio("k7", "pairs", "live")

"""cluster_build_s: seconds the program spent in its Morton clusterings
of the mesh (ops/accel.build_clusters, coarse and fine) in set-up (the
program's counter `scene.clusters_s`)."""

from perfbench import spans


def read(run):
    value = spans.counter("scene.clusters_s")
    return value if value else None

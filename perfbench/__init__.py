"""The benchmark of skele_raytracer_tpu_torch on one NVIDIA H100: the
harness (run.py), its cells' data (configs/, scenes/, traffic/), the
windows' loops (modes/), the per-layer readers (metrics/), the plain
reference (reference/) and the frozen work counts (work/)."""

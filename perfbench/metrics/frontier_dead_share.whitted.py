"""frontier_dead_share.whitted: the share of the Whitted frontier's rows
that carry no weight, in %: Σ (rows - live) ÷ Σ rows over every depth of
the traced frames (the program's counter `wavefront.whitted`: rows from
the frontier's shapes, live rows summed on the device;
models/integrator.py `integrate_whitted`). A program without the counter
gives None."""

from perfbench import spans


def read(run):
    counts = spans.counter("wavefront.whitted")
    if not counts:
        return None
    rows = sum(counts["rows"])
    return 100.0 * (rows - sum(counts["live"])) / rows if rows else None

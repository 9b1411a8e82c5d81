"""graph_share.mesh: the share of the wavefront's chunks that a replay of
a CUDA graph served, in %: replays ÷ (replays + eager) of the program's
counter `wavefront.graph` (models/graphs.py), over the run, set-up's warm
frame included. A chunk whose graph is new runs eagerly before its
capture and counts as eager; captures are counted apart and not read
here."""

from perfbench import spans


def read(run):
    counts = spans.counter("wavefront.graph")
    if not counts:
        return None
    chunks = counts["replays"] + counts["eager"]
    return 100.0 * counts["replays"] / chunks if chunks else None

"""graph_share.frame: the share of the whole-frame K1 renders on the card
that a replay of a CUDA graph served, in %: replays ÷ (replays + eager)
of the program's counter `frame.graph` (models/graphs.py,
models/renderer.py `render_ids_k1`), over the run, set-up's warm frame
included. A frame whose graph is new runs eagerly before its capture and
counts as eager; captures are counted apart and not read here. A program
without the counter gives None."""

from perfbench import spans


def read(run):
    counts = spans.counter("frame.graph")
    if not counts:
        return None
    frames = counts["replays"] + counts["eager"]
    return 100.0 * counts["replays"] / frames if frames else None

"""frame_ms_p95: the 95th percentile of the wall times of every frame in
the window, in ms (host clock; inclusive quantiles)."""

import statistics


def read(run):
    if len(run.item_s) < 20:
        return None
    return 1e3 * statistics.quantiles(run.item_s, n=20,
                                      method="inclusive")[18]

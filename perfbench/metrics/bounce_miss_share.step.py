"""bounce_miss_share.step: the share of K1's bounce records (every record
slot after the primary hit) whose hit bit is 0, in %: the rays K1 traced
and shaded past the scene, from the program's counter `k1.records`
(utils/profiling.py), the records of the last training step traced; None
where the program keeps no such counter or it holds no bounce slot."""

from perfbench import spans


def read(run):
    counts = spans.counter("k1.records")
    if not counts:
        return None
    bounces = counts["slots"][1:]
    records = sum(s["records"] for s in bounces)
    if not records:
        return None
    return 100.0 * (records - sum(s["hits"] for s in bounces)) / records

"""search_roofline: the least time the window's batches need on the card
for the whole search (``roofline.py``: centroids, probed codes and
scales, the shortlist's fp32 rows, queries and answers; the coarse, scan
and rerank products), over the traced window's wall time, in %.  It
stands in for a model's mfu in these cells, which run none."""
from portbench import roofline


def read(run):
    if run.trace is None or not run.batches or run.trace.window_s <= 0:
        return None
    return 100.0 * roofline.window_least_s(run)["search_s"] \
        / run.trace.window_s

"""tier_host_ms.closed: host milliseconds a batch spends outside the
search: the window's length over the batches it served, less their mean
ServeResponse.compute_ms (submissions, batch forming, padding, slicing,
delivery and the callers' resubmissions)."""
import numpy as np


def read(run):
    ms = run.window.batch_compute_ms
    if not ms:
        return None
    return 1e3 * run.window.seconds / len(ms) - float(np.mean(ms))

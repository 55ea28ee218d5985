"""search_ms.closed: the mean of the serving tier's own compute time of a
batch (ServeResponse.compute_ms: the search through to a synchronize),
one reading a batch."""
import numpy as np


def read(run):
    ms = run.window.batch_compute_ms
    return float(np.mean(ms)) if ms else None

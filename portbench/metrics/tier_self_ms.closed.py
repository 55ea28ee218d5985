"""tier_self_ms.closed: the port's own host milliseconds a batch in its
serving tier: the self time (less their child spans) of every
``rt.serve.*`` span but ``rt.serve.sync`` (the host waiting on the card),
summed over the traced window, over its batches.  The port's part of
``tier_host_ms.closed``, which also counts the caller's own loop."""
from portbench import program_spans

program_spans.install()


def read(run):
    maps = program_spans.maps_of(run.trace)
    n = len(run.window.batch_compute_ms)
    if maps is None or not n:
        return None
    s = sum(r["self_seconds"] for name, r in maps["program_spans"].items()
            if name.startswith("rt.serve.") and name != "rt.serve.sync")
    return 1e3 * s / n

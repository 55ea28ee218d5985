"""mcut_device_ms.closed: device milliseconds a batch of the operations
launched inside the ivf search's m-cut (the span ``rt.ivf.mcut``: the
stable sort of every scanned slot and the two gathers of its best m),
over the window's batches."""
from portbench import program_spans

program_spans.install()


def read(run):
    maps = program_spans.maps_of(run.trace)
    n = len(run.window.batch_compute_ms)
    if maps is None or "rt.ivf.mcut" not in maps["program_spans"] or not n:
        return None
    return 1e3 * maps["device_by_program_span"].get("rt.ivf.mcut", 0.0) / n

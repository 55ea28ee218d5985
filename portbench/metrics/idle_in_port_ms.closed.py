"""idle_in_port_ms.closed: milliseconds a batch the card sat idle while
some ``rt.*`` span of the port was open (each idle gap split by overlap
across the innermost open span), over the window's batches."""
from portbench import program_spans

program_spans.install()


def read(run):
    maps = program_spans.maps_of(run.trace)
    n = len(run.window.batch_compute_ms)
    if maps is None or not n:
        return None
    s = sum(v for name, v in maps["idle_by_program_span"].items()
            if name != program_spans.OUTSIDE)
    return 1e3 * s / n

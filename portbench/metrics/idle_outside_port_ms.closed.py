"""idle_outside_port_ms.closed: milliseconds a batch the card sat idle
while no ``rt.*`` span of the port was open: the caller's own loop, here
the load generator, over the window's batches."""
from portbench import program_spans

program_spans.install()


def read(run):
    maps = program_spans.maps_of(run.trace)
    n = len(run.window.batch_compute_ms)
    if maps is None or not n:
        return None
    idle = maps["idle_by_program_span"].get(program_spans.OUTSIDE, 0.0)
    return 1e3 * idle / n

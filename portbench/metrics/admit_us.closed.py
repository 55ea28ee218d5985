"""admit_us.closed: the mean duration of the port's admission of one
request (``ContinuousBatcher.submit``, the span ``rt.serve.admit``) in
the traced window, in microseconds."""
from portbench import program_spans

program_spans.install()


def read(run):
    maps = program_spans.maps_of(run.trace)
    rec = maps["program_spans"].get("rt.serve.admit") if maps else None
    if not rec or not rec["count"]:
        return None
    return 1e6 * rec["seconds"] / rec["count"]

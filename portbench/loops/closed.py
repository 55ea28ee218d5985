"""``clients`` callers (:func:`portbench.loadgen.closed_loop`); recall
over the answers delivered inside the window."""
from portbench import loadgen

RECALL = "recall_window"


def drive(s, seconds: float) -> loadgen.Window:
    draws = loadgen.QueryDraws(len(s.queries_host), s.seed)
    return loadgen.closed_loop(s.batcher, s.queries_host, draws,
                               clients=s.traffic["clients"],
                               seconds=seconds, spans=s.spans)

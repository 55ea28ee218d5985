"""Poisson arrivals at ``rate_qps`` (:func:`portbench.loadgen.open_loop`);
recall over every request due in the window, answered when it was."""
from portbench import loadgen

RECALL = "recall_all"


def drive(s, seconds: float) -> loadgen.Window:
    draws = loadgen.QueryDraws(len(s.queries_host), s.seed)
    arrivals = loadgen.poisson_arrivals(s.traffic["rate_qps"], seconds,
                                        s.seed)
    return loadgen.open_loop(s.batcher, s.queries_host, draws, arrivals,
                             seconds=seconds, spans=s.spans)

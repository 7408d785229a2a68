"""cg_iter_p95_ms: the 95th percentile of every interval of the window
between successive host-clock stamps of the benchmark's wrapper: one for
each iteration (from its product's call to the next, every iteration
ending in the solver's residual sync) and one for each set's prologue
(A·x0, the first residual and its sync, with the gap after the set
before).  The intervals tile the window; a stall anywhere in it can reach
the tail."""
import numpy as np


def read(run):
    if run.iteration_s.size == 0:
        return None
    return float(np.percentile(run.iteration_s, 95)) * 1e3

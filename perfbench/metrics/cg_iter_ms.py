"""cg_iter_ms: the window's host time over all CG iterations completed in
it (every set's prologue and the host syncs included)."""


def read(run):
    if run.iterations <= 0:
        return None
    return run.window_s / run.iterations * 1e3

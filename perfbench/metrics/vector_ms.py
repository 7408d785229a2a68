"""vector_ms: device time per CG iteration of every activity outside the
product range (the solver's vector ops, reductions and the residual's
copy to the host), over the traced slice."""


def read(run):
    s = run.slice
    if s is None or run.slice_iterations == 0 or s.other_device_s <= 0:
        return None
    return s.other_device_s / run.slice_iterations * 1e3

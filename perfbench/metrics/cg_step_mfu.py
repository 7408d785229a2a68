"""cg_step_mfu: the least time one whole CG iteration could take on the
card (its product's bytes and flops, plus x, r and p read and written
once and the vector flops, over the published peaks) as a share of the
window's ``cg_iter_ms`` on the host clock, in percent.  HBM bandwidth is
the binding peak."""
from perfbench.harness import roofline


def read(run):
    if run.peaks is None or run.iterations <= 0:
        return None
    bound = roofline.bound_s(
        roofline.iteration_bytes(run.n, run.k, run.nrhs,
                                 run.numerically_symmetric),
        roofline.iteration_flops(run.n, run.nnz, run.nrhs), run.peaks)
    return 100.0 * bound / (run.window_s / run.iterations)

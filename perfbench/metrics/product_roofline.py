"""product_roofline: the least time one product could take on the card
(bytes and flops counted from the CSRC arrays, over the published peaks)
as a share of ``product_ms``, in percent."""
from perfbench.harness import roofline


def read(run):
    s = run.slice
    if (run.peaks is None or s is None or s.product_calls == 0
            or s.product_device_s <= 0):
        return None
    bound = roofline.bound_s(
        roofline.product_bytes(run.n, run.k, run.nrhs,
                               run.numerically_symmetric),
        roofline.product_flops(run.n, run.nnz, run.nrhs), run.peaks)
    return 100.0 * bound / (s.product_device_s / s.product_calls)

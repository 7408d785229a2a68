"""split_ms: device time of K15's chunk kernel (``segment_chunk_kernel``,
which walks the chunks of the rows K15 splits), per operator call, over the
traced slice.  None where the slice holds no such kernel: a matrix without
heavy rows, or a program without the split."""

KERNEL = "segment_chunk_kernel"


def read(run):
    s = run.slice
    if s is None or s.product_calls == 0:
        return None
    times = [t for name, t in s.device_ops if KERNEL in name]
    if not times:
        return None
    return sum(times) / s.product_calls * 1e3

"""product_ms: device time of every activity launched inside the
benchmark's product range, per operator call, over the traced slice."""


def read(run):
    s = run.slice
    if s is None or s.product_calls == 0 or s.product_device_s <= 0:
        return None
    return s.product_device_s / s.product_calls * 1e3

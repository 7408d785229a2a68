"""The counted synthetic token stream (``pipeline``)."""

"""Atomic, keep-k, cross-loadable checkpoints (``ckpt``)."""

"""Training: ``step`` (``TrainState``, ``make_train_step`` with
microbatches, remat and the accumulation dtype) and ``trainer`` (the loop
with checkpoints, retries, resume and the straggler monitor)."""

"""The optimizer: ``adamw`` (AdamW with global-norm clipping and the
warm-up / cosine schedule) and ``compress`` (bf16 gradient accumulation
with an fp32 error-feedback residual, and the compressed all-reduce
``compressed_psum``)."""

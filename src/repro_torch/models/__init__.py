"""The LM model zoo's dense family: ``layers`` (norms, rope, gated MLPs),
``attention`` (GQA prefill / decode, ring and int8 caches), ``mla``
(DeepSeek-V2 latent attention), ``moe`` (sort-based capacity dispatch) and
``transformer`` (``DenseLM``, ``build_model``)."""

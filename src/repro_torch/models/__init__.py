"""The LM model zoo: ``layers`` (norms, rope, gated MLPs), ``attention``
(GQA prefill / decode, ring and int8 caches), ``mla`` (DeepSeek-V2 latent
attention), ``moe`` (sort-based capacity dispatch), ``rwkv6`` (RWKV6
time-mix and channel-mix), ``mamba2`` (the Mamba2 SSD block) and
``transformer`` (``DenseLM``, ``RWKVLM``, ``HybridLM``, ``build_model``),
and ``sharding`` (the rules that place params, decode states and
activations on a mesh)."""

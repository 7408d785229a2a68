"""repro_torch — the PyTorch / CUDA port of the CSRC SpMV system.

Same sub-package and module names as the JAX package (``core``,
``kernels``, ``obs``, ``serve``) so each counterpart is found by name.
Entry points take ``device=`` and default to the card (``"cuda"``); only
a caller that passes ``device="cpu"`` runs the plain PyTorch versions of
the kernels on the host.  The hand-written CUDA kernels live under
``csrc/`` and are compiled with ``nvcc`` at first use
(``kernels/_build.py``); importing the package needs neither a compiler
nor a card.
"""

"""``test_torch_train_grads.py``'s gradient parity for the MLA + MoE arch
(deepseek-v2-lite-16b, bar 1e-5) and the Mamba2 hybrid (zamba2-7b, bar
5e-4), in a file of their own so that parallel workers splitting the
suite by file (`--dist loadfile`) run the two halves side by side."""
import pytest

from test_torch_train_grads import (  # noqa: F401 (collected here too)
    run_grads, test_every_leaf_matches_the_reference,
    test_loss_and_metrics_match, test_remat_leaves_the_gradient_unchanged)


@pytest.fixture(scope="module", params=["deepseek-v2-lite-16b", "zamba2-7b"])
def grads(request):
    return run_grads(request.param)

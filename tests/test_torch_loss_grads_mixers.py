"""Port parity: ``LModel.loss_fn`` and its gradients against
``jax.value_and_grad`` for the archs with other mixers and FFNs:
moonshot-v1-16b-a3b (MoE, its aux loss in the loss), falcon-mamba-7b
(Mamba's doubling scan), recurrentgemma-9b (RG-LRU, local attention and a
remainder layer) and grok-1-314b (MoE with the attention soft-cap).
Helpers and tolerances are ``test_torch_loss_grads.py``'s; the MoE's
gradients come from autograd through the port's sort/``searchsorted``/
gather dispatch, the JAX package's from its ``custom_vjp`` gathers.
"""
import pytest

from test_torch_loss_grads import check_loss_and_grads
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "grok-1-314b"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)

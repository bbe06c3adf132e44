"""Port parity: ``LModel.loss_fn`` and its gradients against the JAX
package's ``jax.value_and_grad(loss_fn)``, one arch of a family a case
(qwen3-8b dense, gemma3-4b local attention, whisper-large-v3 enc-dec
here; the MoE, SSM and RG-LRU archs in ``test_torch_loss_grads_mixers
.py``), at smoke size in float32.

The same parameters (``jax.random``, carried across by
``models.convert.load_jax_params``) and the same numpy batch go through
both.  The loss agrees within ``rtol=1e-5``; each gradient leaf within
``1e-4`` of that leaf's largest JAX magnitude (the two frameworks sum
the backward pass in other orders; the largest error seen is under
1e-5 of it).  The port's loss runs with ``cfg.remat`` on (the configs'
default), so its checkpointed backward pass is what is compared.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import smoke_config as jax_smoke_config
from repro.models import param as rparam
from repro.models.model import LModel as JaxLModel

import torch
from repro_torch.configs import smoke_config
from repro_torch.models import convert
from repro_torch.models.model import LModel
from repro_torch.models.param import leaves
from torch_threads import one_thread  # noqa: F401

GRAD_REL = 1e-4


def models(arch, seed=0, **change):
    """The JAX model and parameters, and the port's model holding them
    (float32, ``max_seq`` 64)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               **change)
    jm = JaxLModel(jcfg, max_seq=64)
    params = rparam.materialize(jm.param_specs(), jax.random.key(seed),
                                dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                               **change)
    model = LModel(tcfg, max_seq=64, device="cpu", dtype=torch.float32)
    convert.load_jax_params(model, jax.tree.map(np.asarray, params))
    return jm, params, model


def batch(cfg, B=2, S=16, seed=0):
    """A numpy batch: tokens, labels (and whisper's frame embeddings)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.enc_dec:
        b["enc_inputs"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return b


def check_loss_and_grads(arch):
    jm, params, model = models(arch)
    b = batch(model.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    tensors = model.param_leaves()
    for t in tensors:
        t.requires_grad_(True)
    loss = model.loss_fn({k: torch.as_tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = list(leaves(jax.tree.map(np.asarray, jgrads)))
    assert len(want) == len(grads)
    for (path, w), g in zip(want, grads):
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == w.shape, path
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_REL * float(np.abs(w).max()) + 1e-12,
            err_msg="/".join(map(str, path)))


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-4b",
                                  "whisper-large-v3"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)

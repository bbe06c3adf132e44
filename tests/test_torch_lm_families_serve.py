"""Port parity: the decoder-only LM families served, at smoke size,
against the JAX ``BatchScheduler``, and through the port's entry point.

The families and tolerances are ``test_torch_lm_families.py``'s; each
run admits more requests than there are slots, so a slot is reused by a
later request, its KV rings and SSM states overwritten on admission.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import LModel as JaxLModel
from repro.serve.decode import BatchScheduler as JaxScheduler
from repro.serve.decode import Request as JaxRequest
from repro.serve.decode import slot_view as jax_slot_view

import torch
from repro_torch.launch import serve as tserve
from repro_torch.models.model import LModel
from repro_torch.serve.decode import BatchScheduler, Request, slot_view

from test_torch_lm_families import FAMILIES, _check_cache, _models
from torch_threads import one_thread  # noqa: F401


@dataclasses.dataclass(frozen=True)
class _JaxF32Cache(JaxLModel):
    """The JAX model with float32 caches: its scheduler's bf16 cache cannot
    carry a float32 model's SSM states (the prefill scan's carry would
    change dtype), so both schedulers take float32 caches here."""

    def init_cache(self, batch, capacity, dtype=jnp.float32, cross_len=0):
        return super().init_cache(batch, capacity, dtype=dtype,
                                  cross_len=cross_len)


@pytest.mark.parametrize("arch", FAMILIES)
def test_scheduler_matches_jax(arch):
    """2 slots, 5 requests (slots reused by later requests), 6 new tokens:
    the same token streams as the JAX scheduler, and the slots' final
    caches, KV rings and SSM states alike, one slot at a time."""
    _, params, model = _models(arch)
    jm = _JaxF32Cache(dataclasses.replace(jax_smoke_config(arch),
                                          dtype="float32"))
    model.init_cache = functools.partial(LModel.init_cache, model,
                                         dtype=torch.float32)
    rng = np.random.default_rng(0)
    # two prompt lengths: each is one compile of the JAX prefill
    prompts = [rng.integers(0, 512, int(rng.choice([3, 9])))
               for _ in range(5)]
    js = JaxScheduler(jm, params, slots=2, capacity=24)
    ps = BatchScheduler(model, slots=2, capacity=24)
    for i, p in enumerate(prompts):
        js.submit(JaxRequest(i, p, 6))
        ps.submit(Request(i, p, 6))
    want = {r.rid: r.out for r in js.run()}
    got = {r.rid: r.out for r in ps.run()}
    assert got == want
    assert len(ps.prefill_walls_s) == 5 and ps.step_syncs == []
    for slot in range(2):
        _check_cache(jax_slot_view(js.cache, slot), slot_view(ps.cache,
                                                              slot))


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_serves_the_family(arch, capsys):
    """The entry point, ``launch.serve.main --arch <arch> --smoke``,
    serves every request (more than the slots)."""
    sched = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--slots", "2", "--requests", "3", "--max-new",
                         "4"])
    assert len(sched.done) == 3
    assert all(len(r.out) == 4 for r in sched.done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out

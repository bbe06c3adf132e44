"""The port's expert-parallel MoE (``models.moe.apply_moe_shardmap``) over
a (2, 4) mesh of CPU devices, against the port's gather path and the JAX
package's ``apply_moe_shardmap`` on its 8 host devices (the suite's
conftest gives them), at smoke width in float32.  The bounds are
``tests/test_moe.py``'s: forward 1e-5, aux 1e-6, gradients 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.configs.registry import smoke_config as jsmoke_config
from repro.core._jax_compat import make_mesh as jmake_mesh
from repro.core._jax_compat import set_mesh as jset_mesh
from repro.models import moe as JM

from repro_torch.configs.registry import smoke_config
from repro_torch.core.comm import CommManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as M
from repro_torch.sharding import partition as ps

from torch_threads import one_thread  # noqa: F401

GRID = (2, 4)
B, S = 4, 16


def _cfg(mod, **kw):
    base = (smoke_config if mod is M else jsmoke_config)(
        "moonshot-v1-16b-a3b")
    return dataclasses.replace(base, moe_impl="shardmap", n_experts=8, **kw)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {"router": rng.normal(size=(D, E)).astype(np.float32) * 0.3,
         "w_up": rng.normal(size=(E, D, F)).astype(np.float32) * 0.1,
         "w_gate": rng.normal(size=(E, D, F)).astype(np.float32) * 0.1,
         "w_down": rng.normal(size=(E, F, D)).astype(np.float32) * 0.1}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    return p, x


def _torch(p, x, grad=False):
    tp = {k: torch.tensor(v, requires_grad=grad) for k, v in p.items()}
    return tp, torch.tensor(x, requires_grad=grad)


def _mesh():
    return make_mesh(GRID, ("data", "model"), "cpu")


def _loss(y, aux):
    return (y * y).sum() + aux


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_ep_forward_and_gradients_match_the_gather_path(capacity_factor):
    """1.25 drops tokens (the same ones on both paths: a column ranks its
    experts' tokens as the whole layer does); 4.0 drops none."""
    cfg = _cfg(M, capacity_factor=capacity_factor)
    p, x = _inputs(cfg)
    tp, tx = _torch(p, x, grad=True)
    y_ref, aux_ref = M.apply_moe(cfg, tp, tx)
    g_ref = torch.autograd.grad(_loss(y_ref, aux_ref), [*tp.values(), tx])
    tp2, tx2 = _torch(p, x, grad=True)
    with ps.set_mesh(_mesh()):
        y, aux = M.apply_moe_shardmap(cfg, tp2, tx2)
    g = torch.autograd.grad(_loss(y, aux), [*tp2.values(), tx2])
    np.testing.assert_allclose(y.detach().numpy(), y_ref.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    assert abs(float(aux.detach()) - float(aux_ref.detach())) <= 1e-6
    for name, a, b in zip([*tp, "x"], g, g_ref):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_ep_matches_jax_shardmap_forward_and_gradients():
    cfg, jcfg = _cfg(M), _cfg(JM)
    p, x = _inputs(cfg, seed=1)
    jmesh = jmake_mesh(GRID, ("data", "model"))
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def jloss(p_, x_):
        y_, a_ = JM.apply_moe_shardmap(jcfg, p_, x_)
        return jnp.sum(y_ * y_) + a_, (y_, a_)

    with jset_mesh(jmesh):
        (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp, tx = _torch(p, x, grad=True)
    comm = CommManager(devices=_mesh().device_list())
    with ps.set_mesh(_mesh(), comm=comm):
        y, aux = M.apply_moe_auto(cfg, tp, tx)
    g = torch.autograd.grad(_loss(y, aux), [*tp.values(), tx])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    want = [np.asarray(jg[0][k]) for k in tp] + [np.asarray(jg[1])]
    for name, a, b in zip([*tp, "x"], g, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=name)
    # the psum of every cell's (rows, S, D) partial, one exchange a call
    rows = B // GRID[0]
    assert comm.stats.collective_supersteps == 1
    assert comm.stats.collective_bytes_total == (
        GRID[0] * GRID[1] * rows * S * cfg.d_model * 4)


@pytest.mark.parametrize("case,takes_ep", [
    ("mesh", True), ("no_mesh", False), ("gather_impl", False),
    ("experts_indivisible", False), ("batch_indivisible", False),
    ("one_model_column", False)])
def test_auto_takes_ep_under_the_jax_conditions(case, takes_ep):
    cfg = _cfg(M)
    mesh = _mesh()
    batch = B
    if case == "gather_impl":
        cfg = dataclasses.replace(cfg, moe_impl="gather")
    elif case == "experts_indivisible":
        cfg = dataclasses.replace(cfg, n_experts=6)
    elif case == "batch_indivisible":
        batch = 3
    elif case == "one_model_column":
        mesh = make_mesh((8, 1), ("data", "model"), "cpu")
    p, x = _inputs(cfg)
    tp, tx = _torch(p, x[:batch])
    comm = CommManager()
    if case == "no_mesh":
        y, aux = M.apply_moe_auto(cfg, tp, tx)
        assert not M.ep_applies(cfg, None, batch)
    else:
        assert M.ep_applies(cfg, mesh, batch) == takes_ep
        with ps.set_mesh(mesh, comm=comm):
            y, aux = M.apply_moe_auto(cfg, tp, tx)
    assert (comm.stats.collective_supersteps == 1) == takes_ep
    y_ref, aux_ref = M.apply_moe(cfg, tp, tx)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(aux.detach()) - float(aux_ref.detach())) <= 1e-6


def test_ep_over_pod_and_data_rows():
    """Batch rows split over ('pod', 'data') in C order, the JAX
    ``P(('pod', 'data'))``."""
    cfg = _cfg(M)
    p, x = _inputs(cfg, seed=2)
    tp, tx = _torch(p, x)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    with ps.set_mesh(mesh):
        y, aux = M.apply_moe_shardmap(cfg, tp, tx)
    y_ref, aux_ref = M.apply_moe(cfg, tp, tx)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(aux.detach()) - float(aux_ref.detach())) <= 1e-6

"""Reshard on restore (``train.checkpoint.restore(shardings=)``): a tree
sharded over one mesh of CPU devices, saved, restored onto another mesh
and joined by ``sharding.partition.unshard``, bit for bit; a checkpoint
the JAX package wrote, restored by the port onto a mesh."""
import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.train import checkpoint as jckpt

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import device_put, synth_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import LModel
from repro_torch.models.param import leaves, map_tree, specs, unflatten
from repro_torch.sharding import partition as ps
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

from torch_threads import one_thread  # noqa: F401


def _bits(t):
    return t.detach().view(torch.uint8) if t.dim() else t.detach()


def _same_bits(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(_bits(x), _bits(y)), path


def _shardings(model, grid):
    mesh = make_mesh(grid, ("data", "model"), "cpu")
    pspec = specs(model.param_specs(), mesh, ps.TRAIN_RULES, fsdp=True)
    return ps.named_shardings({"params": pspec, "opt": {
        "m": pspec, "v": pspec, "step": ps.PartitionSpec()}}, mesh)


def _whisper_tree():
    """Whisper at smoke width with its d_model raised to 128, so that
    the (4, 2) mesh's FSDP and model axes split leaves; its parameters
    and AdamW state after one step."""
    cfg = dataclasses.replace(smoke_config("whisper-large-v3"), d_model=128,
                              microbatch_seqs=2)
    model = LModel(cfg, max_seq=16, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    ocfg = O.OptConfig(peak_lr=1e-3, warmup_steps=1)
    state = O.init_state(ocfg, model.param_tree())
    batch = device_put(synth_batch(cfg, ShapeConfig("t", 16, 4, "train"), 0),
                       "cpu")
    state, _ = make_train_step(model, ocfg)(state, batch)
    tree = {"params": map_tree(lambda t: t.detach().clone(),
                               model.param_tree()), "opt": state}
    return model, tree


def test_reshard_4x2_to_2x2_bit_for_bit(tmp_path):
    model, tree = _whisper_tree()
    src, dst = _shardings(model, (4, 2)), _shardings(model, (2, 2))
    src_flat, dst_flat = dict(leaves(src)), dict(leaves(dst))
    held = {path: src_flat[path].split(t) for path, t in leaves(tree)}
    flat = dict(leaves(tree))
    # leaves split over the mesh, not only replicated
    assert sum(held[p][0].shape != flat[p].shape for p in held) > 10
    d = str(tmp_path)
    ckpt.save(d, 1, unflatten((path, ps.unshard(parts, src_flat[path]))
                              for path, parts in held.items()))
    restored = ckpt.restore(d, 1, tree, shardings=dst)
    joined = []
    for (path, t), (_, node) in zip(leaves(tree), leaves(restored)):
        assert isinstance(node, list) and len(node) == 4
        for (dev, index), part in zip(dst_flat[path].shard_slices(t.shape),
                                      node):
            assert part.device == dev
            assert torch.equal(_bits(part), _bits(t[index]))
        joined.append((path, ps.unshard(node, dst_flat[path])))
    _same_bits(unflatten(joined), tree)


def test_restore_shards_only_the_named_leaves(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(64.0).reshape(8, 8),
            "b": torch.arange(8, dtype=torch.int32)}
    ckpt.save(d, 1, tree)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    sh = ps.NamedSharding(mesh, ps.PartitionSpec("data", "model"))
    out = ckpt.restore(d, 1, tree, shardings={"w": sh})
    assert isinstance(out["b"], torch.Tensor)
    assert torch.equal(out["b"], tree["b"])
    assert [tuple(p.shape) for p in out["w"]] == [(4, 4)] * 4
    assert torch.equal(ps.unshard(out["w"], sh), tree["w"])


def test_jax_checkpoint_resharded_by_the_port(tmp_path):
    """The JAX package's elastic-restart case (tests/test_sharding.py):
    a (8, 8) leaf written by the JAX package, restored by the port onto a
    (2, 2) mesh; a bfloat16 leaf too, which the JAX restore cannot read."""
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    b16 = rng.normal(size=(4, 6)).astype(np.float32)
    jckpt.save(d, 1, {"w": jnp.arange(64.0).reshape(8, 8),
                      "h": jnp.asarray(b16, jnp.bfloat16)})
    like = {"w": torch.zeros(8, 8), "h": torch.zeros(4, 6,
                                                     dtype=torch.bfloat16)}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    shardings = {"w": ps.NamedSharding(mesh, ps.PartitionSpec("data",
                                                              "model")),
                 "h": ps.NamedSharding(mesh, ps.PartitionSpec(None, "model"))}
    out = ckpt.restore(d, 1, like, shardings=shardings)
    w = ps.unshard(out["w"], shardings["w"])
    np.testing.assert_array_equal(w.numpy(), np.arange(64.0).reshape(8, 8))
    h = ps.unshard(out["h"], shardings["h"])
    want = torch.tensor(b16).to(torch.bfloat16)
    assert h.dtype == torch.bfloat16 and torch.equal(_bits(h), _bits(want))

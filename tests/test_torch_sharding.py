"""The port's logical-axis sharding (``repro_torch.sharding.partition``)
and meshes (``repro_torch.launch.mesh``) against the JAX package's.

The JAX resolver reads a mesh only through ``axis_names`` and
``devices.shape`` (``MeshInfo.from_mesh``), and ``input_specs`` builds a
``NamedSharding`` on it, so an ``AbstractMesh`` given a ``devices`` array
stands in for the 256 or 512 devices of the production meshes.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import input_specs as jinput_specs
from repro.models import param as jparam
from repro.models.model import LModel as JLModel
from repro.sharding import partition as jps

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, get_config, input_specs
from repro_torch.launch import mesh as M
from repro_torch.models import param as P
from repro_torch.models.model import LModel
from repro_torch.sharding import partition as ps

from torch_threads import one_thread  # noqa: F401

MESH = ps.MeshInfo({"data": 16, "model": 16})
POD_MESH = ps.MeshInfo({"pod": 2, "data": 16, "model": 16})
JMESH = jps.MeshInfo({"data": 16, "model": 16})
JPOD_MESH = jps.MeshInfo({"pod": 2, "data": 16, "model": 16})


class _StandIn(jax.sharding.AbstractMesh):
    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _jmesh(multi_pod):
    return (_StandIn((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else _StandIn((16, 16), ("data", "model")))


# tests/test_sharding.py's cases: (shape, axes, pod mesh, rules, fsdp)
RESOLVE_CASES = {
    "heads_shard_when_divisible": ((5120, 32, 128),
                                   ("embed", "heads", "head_dim"), False,
                                   "TRAIN_RULES", True),
    "kv_heads_fallback_when_indivisible": ((5120, 8, 128),
                                           ("embed", "kv_heads", "head_dim"),
                                           False, "TRAIN_RULES", True),
    "moonshot_kv16_shards": ((2048, 16, 128),
                             ("embed", "kv_heads", "head_dim"), False,
                             "TRAIN_RULES", True),
    "expert_parallel": ((64, 2048, 1408), ("experts", "embed", "expert_ffn"),
                        False, "TRAIN_RULES", True),
    "expert_tp_fallback": ((8, 6144, 32768),
                           ("experts", "embed", "expert_ffn"), False,
                           "TRAIN_RULES", True),
    "vocab_tables_skip_fsdp": ((131072, 5120), ("vocab", "embed"), False,
                               "TRAIN_RULES", True),
    "whisper_vocab_indivisible_falls_back": ((51866, 1280),
                                             ("vocab", "embed"), False,
                                             "TRAIN_RULES", True),
    "batch_takes_pod_and_data": ((256, 4096), ("batch", "seq"), True,
                                 "TRAIN_RULES", False),
    "decode_cache_seq_sharding": ((128, 32768, 8, 128),
                                  ("batch", "cache_seq", "cache_kv",
                                   "head_dim"), False, "DECODE_RULES",
                                  False),
    "long_context_batch1": ((1, 524288, 4, 256),
                            ("batch", "cache_seq", "cache_kv", "head_dim"),
                            False, "DECODE_RULES", False),
}
# what tests/test_sharding.py asserts of each
EXPECTED = {
    "heads_shard_when_divisible": ("data", "model", None),
    "kv_heads_fallback_when_indivisible": ("data", None, None),
    "moonshot_kv16_shards": ("data", "model", None),
    "expert_parallel": ("model", "data", None),
    "expert_tp_fallback": (None, "data", "model"),
    "vocab_tables_skip_fsdp": ("model", None),
    "whisper_vocab_indivisible_falls_back": (None, None),
    "batch_takes_pod_and_data": (("pod", "data"), "model"),
    "decode_cache_seq_sharding": ("data", "model", None, None),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_matches_jax(case):
    shape, axes, pod, rules, fsdp = RESOLVE_CASES[case]
    got = ps.resolve(shape, axes, POD_MESH if pod else MESH,
                     getattr(ps, rules), fsdp=fsdp)
    want = jps.resolve(shape, axes, JPOD_MESH if pod else JMESH,
                       getattr(jps, rules), fsdp=fsdp)
    assert tuple(got) == tuple(want)
    if case in EXPECTED:
        assert tuple(got) == EXPECTED[case]
    else:                                   # batch=1: seq takes the axes
        assert got[0] is None and got[1] is not None


def test_rule_tables_are_the_jax_tables():
    for name in ("TRAIN_RULES", "PREFILL_RULES", "DECODE_RULES"):
        assert dict(getattr(ps, name)) == dict(getattr(jps, name))
    assert ps.FSDP_AXIS == jps.FSDP_AXIS


def _names(pairs):
    return ["/".join(str(k) for k in path) for path, _ in pairs]


def _jax_leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path),
             leaf) for path, leaf in flat]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_spec_matches_jax(arch, multi_pod):
    """Every leaf of the param, cache and input specs under the three rule
    tables on a production mesh, against the JAX package's."""
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    jmesh = _jmesh(multi_pod)
    cfg, jcfg = get_config(arch), jget_config(arch)
    dec = SHAPES["decode_32k"]
    cross = cfg.enc_len_decode if cfg.enc_dec else 0
    model = LModel(cfg, max_seq=dec.seq_len if cfg.pos_emb == "learned"
                   else 0, device="meta")
    jmodel = JLModel(jcfg, max_seq=model.max_seq)
    n = 0
    for rules in ("TRAIN_RULES", "PREFILL_RULES", "DECODE_RULES"):
        r, jr = getattr(ps, rules), getattr(jps, rules)
        trees = [(model.param_specs(), jmodel.param_specs(), True),
                 (model.param_specs(), jmodel.param_specs(), False),
                 (model.cache_specs(dec.global_batch, dec.seq_len,
                                    cross_len=cross),
                  jmodel.cache_specs(dec.global_batch, dec.seq_len,
                                     cross_len=cross), False)]
        for tree, jtree, fsdp in trees:
            got = list(P.leaves(P.specs(tree, mesh, r, fsdp=fsdp)))
            want = _jax_leaves(jparam.specs(jtree, jmesh, jr, fsdp=fsdp),
                               is_leaf=lambda x: isinstance(x, JP))
            assert _names(got) == _names(want)
            for (path, g), (_, w) in zip(got, want):
                assert tuple(g) == tuple(w), (path, rules, fsdp)
            n += len(got)
        for name, shape in SHAPES.items():
            got = input_specs(cfg, shape, mesh, r)
            want = jinput_specs(jcfg, JSHAPES[name], jmesh, jr)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].shape == tuple(want[k].shape)
                assert tuple(got[k].sharding.spec) == tuple(
                    want[k].sharding.spec), (name, k, rules)
                n += 1
    assert n > 50


def test_abstract_leaves_give_local_bytes():
    mesh = M.make_production_mesh()
    leaf = P.abstract({"w": P.param((5120, 32, 128),
                                    ("embed", "heads", "head_dim"))},
                      mesh, ps.TRAIN_RULES)["w"]
    assert tuple(leaf.sharding.spec) == ("data", "model", None)
    assert leaf.local_shape == (320, 2, 128)
    assert leaf.local_nbytes == 320 * 2 * 128 * 2
    assert leaf.nbytes == 5120 * 32 * 128 * 2
    t = leaf.to_meta()
    assert t.device.type == "meta" and tuple(t.shape) == leaf.shape


@pytest.mark.parametrize("grid,spec", [
    ((4, 2), ("data", "model")), ((4, 2), ("model", None)),
    ((4, 2), (("data", "model"), None)), ((2, 2), (None, "data")),
    ((4, 2), ())])
def test_split_and_unshard_round_trip(grid, spec):
    mesh = M.make_mesh(grid, ("data", "model"), "cpu")
    sh = ps.NamedSharding(mesh, ps.PartitionSpec(*spec))
    x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    parts = sh.split(x)
    assert len(parts) == mesh.size
    assert all(tuple(p.shape) == sh.shard_shape(x.shape) for p in parts)
    assert torch.equal(ps.unshard(parts, sh), x)
    # numpy's block view of the same spec, device by device in C order
    sizes = dict(zip(mesh.axis_names, grid))
    for (dev, index), part in zip(sh.shard_slices(x.shape), parts):
        assert torch.equal(part, x[index])
    if spec == ("data", "model"):
        assert torch.equal(parts[1], x[0:2, 4:8])          # (data 0, model 1)
        assert sizes == {"data": 4, "model": 2}


def test_named_sharding_rejects_unknown_axes_and_indivisible_dims():
    mesh = M.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError):
        ps.NamedSharding(mesh, ps.PartitionSpec("pod"))
    sh = ps.NamedSharding(mesh, ps.PartitionSpec("data"))
    with pytest.raises(ValueError):
        sh.shard_shape((3, 4))


def test_constraints_are_value_no_ops_under_a_mesh():
    mesh = M.make_mesh((2, 4), ("data", "model"), "cpu")
    x = torch.randn(8, 12, 16)
    assert ps.get_mesh() is None
    assert ps.constraint_spec(x.shape, [("pod", "data"), "model"]) is None
    with ps.set_mesh(mesh) as m:
        assert ps.get_mesh() is m
        assert ps.constrain_batch(x) is x
        assert ps.constrain_residual(x) is x
        assert ps.constrain(x, ["data", "model", None]) is x
        # the JAX package's divisibility rule: 12 % 4 == 0, 16 % 2 == 0
        assert tuple(ps.constraint_spec(x.shape, [("pod", "data"), "model",
                                                  None])) == ("data", "model",
                                                              None)
        assert tuple(ps.constraint_spec((3, 6), ["data", ("data", "model")])
                     ) == (None, None)
    assert ps.get_mesh() is None


def test_production_meshes_and_their_links():
    m = M.make_production_mesh()
    assert m.devices.shape == (16, 16) and m.axis_names == ("data", "model")
    assert {d.type for d in m.device_list()} == {"meta"}
    m2 = M.make_production_mesh(multi_pod=True)
    assert m2.devices.shape == (2, 16, 16)
    assert m2.axis_names == ("pod", "data", "model")
    # the 16-wide model axis spans two hosts of 8: the network, not NVLink
    assert M.axis_hosts(m, "model") == 2
    assert M.axis_link(m, "model") == ("network", M.NET_BW)
    assert M.axis_hosts(m, "data") == 16
    assert M.axis_link(m2, ("pod", "data"))[0] == "network"
    small = M.make_mesh((2, 8), ("data", "model"), "meta")
    assert M.axis_link(small, "model") == ("nvlink", M.NVLINK_BW)
    # real devices: one host
    assert M.axis_link(M.make_host_mesh(4, "cpu"), "model")[0] == "nvlink"
    assert (M.PEAK_FLOPS, M.HBM_BW, M.HBM_PER_DEVICE) == (989e12, 3.35e12,
                                                         80e9)


def test_host_mesh_repeats_the_device_and_needs_cuda_by_default():
    m = M.make_host_mesh(3, "cpu")
    assert m.devices.shape == (3,) and m.axis_names == ("model",)
    assert m.device_list() == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            M.make_host_mesh(2)

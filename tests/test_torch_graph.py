"""Port parity: host layouts of ``repro_torch.core.graph``/``preprocess``
against the JAX package's, element for element, on the same numpy edges."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU in tests)
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import graph as RG
from repro.core import preprocess as RP
from repro.kernels import push_ell as rpush

import torch
from repro_torch.core import graph as G
from repro_torch.core import preprocess as P
from repro_torch.kernels import push_ell as tpush
from torch_threads import one_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _edges(V=600, E=4000, seed=0, weights=True):
    src, dst = RG.rmat_edges(V, E, seed=seed)
    w = None
    if weights:
        w = np.random.default_rng(seed + 1).uniform(
            0.5, 4.0, len(src)).astype(np.float32)
    return src, dst, w


def _both(V=600, E=4000, seed=0, weights=True):
    src, dst, w = _edges(V, E, seed, weights)
    return (RG.from_edge_list(src, dst, num_vertices=V, weights=w),
            G.from_edge_list(src, dst, num_vertices=V, weights=w))


def _eq(ref, port):
    """Element-for-element equality of a JAX array and a torch tensor."""
    a = np.asarray(ref)
    b = port.cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _eq_dataclass(ref, port):
    import dataclasses
    for f in dataclasses.fields(port):
        r, p = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(p, torch.Tensor):
            _eq(r, p)
        elif isinstance(p, tuple) and p and isinstance(p[0], torch.Tensor):
            assert len(r) == len(p), f.name
            for x, y in zip(r, p):
                _eq(x, y)
        else:
            assert r == p, (f.name, r, p)


@pytest.mark.parametrize("V,E,seed", [(1000, 8000, 0), (777, 5000, 3),
                                      (64, 512, 7)])
def test_rmat_edges_identical(V, E, seed):
    rs, rd = RG.rmat_edges(V, E, seed=seed)
    ts, td = G.rmat_edges(V, E, seed=seed)
    np.testing.assert_array_equal(rs, ts)
    np.testing.assert_array_equal(rd, td)


@pytest.mark.parametrize("weights", [True, False])
def test_csr_and_reverse_equal(weights):
    rg, tg = _both(weights=weights)
    for name in ("vertex_values", "edge_offsets", "edges_dst",
                 "edge_weights"):
        _eq(getattr(rg, name), getattr(tg, name))
    assert (rg.num_vertices, rg.num_edges) == (tg.num_vertices, tg.num_edges)
    _eq(rg.out_degrees, tg.out_degrees)
    rr, tr = RG.reverse(rg), G.reverse(tg)
    for name in ("edge_offsets", "edges_dst", "edge_weights"):
        _eq(getattr(rr, name), getattr(tr, name))
    for a, b in zip(RG.to_coo(rg), G.to_coo(tg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("V,E,seed", [(600, 4000, 0), (300, 9000, 2)])
def test_bucketize_equal(V, E, seed):
    rg, tg = _both(V, E, seed)
    for max_width in (1024, 16):       # 16 splits hubs across rows
        rb = RG.bucketize(RG.reverse(rg), max_width=max_width)
        tb = G.bucketize(G.reverse(tg), max_width=max_width)
        _eq_dataclass(rb, tb)


@pytest.mark.parametrize("block_slots", [64, 8, 128])
def test_pull_bitmap_plan_equal(block_slots):
    rg, tg = _both(V=500, E=6000, seed=4)
    rb = RG.bucketize(RG.reverse(rg), max_width=32)
    tb = G.bucketize(G.reverse(tg), max_width=32)
    _eq_dataclass(RG.pull_bitmap_plan(rb, block_slots=block_slots),
                  G.pull_bitmap_plan(tb, block_slots=block_slots))


@pytest.mark.parametrize("width", [8, 4, 1])
def test_forward_ell_equal(width):
    rg, tg = _both(seed=5)
    _eq_dataclass(RG.forward_ell(rg, width=width),
                  G.forward_ell(tg, width=width))


def test_forward_ell_edgeless_equal():
    rg = RG.from_edge_list(np.zeros(0, np.int32), np.zeros(0, np.int32),
                           num_vertices=5)
    tg = G.from_edge_list(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          num_vertices=5)
    _eq_dataclass(RG.forward_ell(rg), G.forward_ell(tg))


def test_layouts_for_caches_and_matches():
    rg, tg = _both(seed=6)
    P.layout_cache_clear()
    rl, tl = RP.layouts_for(rg), P.layouts_for(tg)
    assert P.layouts_for(tg) is tl
    _eq_dataclass(rl.pull_plan(64), tl.pull_plan(64))
    _eq_dataclass(rl.forward_ell(8), tl.forward_ell(8))
    _eq_dataclass(rl.reverse_bucketed(), tl.reverse_bucketed())
    assert tl.on(tl.forward_ell(8), "cpu") is tl.on(tl.forward_ell(8), "cpu")
    assert set(tl.build_times_s) >= {"reverse", "reverse_bucketed",
                                     "pull_plan_s64", "forward_ell_w8"}


@pytest.mark.parametrize("n,density,capacity,num_items", [
    (1000, 0.1, 200, 900), (77, 0.5, 80, None), (31, 0.0, 8, None)])
def test_bitmap_select_and_compact_rows_equal(n, density, capacity,
                                              num_items):
    mask = np.random.default_rng(n).random(n) < density
    rw = RG.pack_bits(jnp.asarray(mask))
    tw = G.pack_bits(torch.as_tensor(mask))
    np.testing.assert_array_equal(np.asarray(rw).astype(np.int64),
                                  tw.numpy())
    np.testing.assert_array_equal(np.asarray(RG.popcount_words(rw)),
                                  G.popcount_words(tw).numpy())
    ri, rok = RG.bitmap_select(rw, capacity, num_items=num_items)
    ti, tok = G.bitmap_select(tw, capacity, num_items=num_items)
    _eq(ri, ti)
    _eq(rok, tok)
    rows = num_items if num_items is not None else n
    ri, rok = rpush.compact_rows(jnp.asarray(mask), rows, capacity)
    ti, tok = tpush.compact_rows(torch.as_tensor(mask), rows, capacity)
    _eq(ri, ti)
    _eq(rok, tok)


def test_graph_from_arrays_matches_from_edge_list():
    src, dst, w = _edges(seed=8)
    rg = RG.from_edge_list(src, dst, num_vertices=600, weights=w)
    carried = G.graph_from_arrays(
        np.asarray(rg.edge_offsets), np.asarray(rg.edges_dst),
        np.asarray(rg.edge_weights), np.asarray(rg.vertex_values),
        rg.num_vertices, device="cpu")
    own = G.from_edge_list(src, dst, num_vertices=600, weights=w)
    for name in ("vertex_values", "edge_offsets", "edges_dst",
                 "edge_weights"):
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
        assert getattr(carried, name).dtype == getattr(own, name).dtype
    assert (carried.num_vertices, carried.num_edges) == \
        (own.num_vertices, own.num_edges)


def test_paper_graph_and_edge_list_io(tmp_path):
    g = P.load_paper_graph("email-Eu-core", cache_dir=str(tmp_path))
    rg = RP.load_paper_graph("email-Eu-core")
    _eq(rg.edges_dst, g.edges_dst)
    again = P.load_paper_graph("email-Eu-core", cache_dir=str(tmp_path))
    assert torch.equal(again.edges_dst, g.edges_dst)
    path = str(tmp_path / "e.txt")
    P.write_edge_list(path, np.array([0, 1, 2]), np.array([1, 2, 0]))
    s, d = P.read_edge_list(path)
    np.testing.assert_array_equal(s, [0, 1, 2])
    np.testing.assert_array_equal(d, [1, 2, 0])


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 38, names\n"
        "assert {'repro_torch.kernels.segment_sum',"
        " 'repro_torch.kernels.push_scatter',"
        " 'repro_torch.kernels.decode_gqa', 'repro_torch.configs.qwen3_8b',"
        " 'repro_torch.models.model', 'repro_torch.models.convert',"
        " 'repro_torch.models.moe', 'repro_torch.models.ssm',"
        " 'repro_torch.serve.decode', 'repro_torch.launch.serve'}"
        " <= set(names), names\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_chip_smoke_imports_neither_jax_nor_repro():
    """The GPU smoke script names no module of JAX or the JAX package."""
    import ast
    path = os.path.join(os.path.dirname(SRC), "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_chip_smoke_fails_without_a_card():
    """With no CUDA device the smoke script exits non-zero and prints no
    result line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(SRC), "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert "is_available() is false" in out.stderr
    assert '"ok"' not in out.stdout

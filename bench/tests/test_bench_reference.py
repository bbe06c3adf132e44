"""Each plain reference against graphs solved by hand, and each control
against its reference."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from bench.reference import bfs, ppr, sssp

UNREACHED = 2 ** 30


def _both(pairs, w=None):
    u = torch.tensor([a for a, _ in pairs])
    v = torch.tensor([b for _, b in pairs])
    src, dst = torch.cat([u, v]), torch.cat([v, u])
    if w is None:
        return src, dst
    w = torch.tensor(w, dtype=torch.float32)
    return src, dst, torch.cat([w, w])


def test_bfs_levels_by_hand():
    # 0-1-2-3 path, 1-4, a self-loop on 4; 5 alone
    src, dst = _both([(0, 1), (1, 2), (2, 3), (1, 4), (4, 4)])
    lv = bfs.bfs_levels(src, dst, 6, 0, UNREACHED)
    assert lv.tolist() == [0, 1, 2, 3, 2, UNREACHED]
    assert bfs.depth(lv, UNREACHED) == 3
    # the control: the last level left out
    short = bfs.bfs_levels(src, dst, 6, 0, UNREACHED, max_levels=2)
    assert short.tolist() == [0, 1, 2, UNREACHED, 2, UNREACHED]


def test_sssp_by_hand():
    # 0-1 (0.5), 1-2 (0.25), 0-2 (1.0), 2-3 (0.125); 4 alone
    src, dst, w = _both([(0, 1), (1, 2), (0, 2), (2, 3)],
                        [0.5, 0.25, 1.0, 0.125])
    d = sssp.sssp(src, dst, w, 5, 0)
    assert d.tolist() == [0.0, 0.5, 0.75, 0.875, float("inf")]
    assert d.dtype == torch.float32


def test_sssp_keeps_float32_rounding_along_the_path():
    # 1e-8 vanishes when added to 1.0 in float32, so the long way ties
    src, dst, w = _both([(0, 1), (1, 2), (0, 2)], [1.0, 1e-8, 1.0])
    d = sssp.sssp(src, dst, w, 3, 0)
    assert d[2].item() == 1.0


def test_sssp_in_bfloat16_rounds_differently():
    src, dst, w = _both([(0, 1), (1, 2)], [0.1, 0.3])
    exact = sssp.sssp(src, dst, w, 3, 0)
    low = sssp.sssp(src, dst, w, 3, 0, torch.bfloat16).float()
    assert not torch.equal(exact, low)


def test_ppr_by_hand():
    # two vertices joined both ways: x0 = 0; x_{t+1} = 0.15 e_0 + 0.85 P x_t
    src, dst = _both([(0, 1)])
    x = ppr.ppr(src, dst, 2, 0, 0.85, 2)
    # step 1: (0.15, 0); step 2: (0.15, 0.85 * 0.15)
    assert x.tolist() == pytest.approx([0.15, 0.85 * 0.15])
    x = ppr.ppr(src, dst, 2, 0, 0.85, 3)
    assert x.tolist() == pytest.approx([0.15 + 0.85 * 0.85 * 0.15,
                                        0.85 * 0.15])


def test_ppr_divides_by_out_degree_counting_duplicates():
    # 0 has two edges to 1 and one to 2: 1 gets two thirds of 0's mass
    src = torch.tensor([0, 0, 0, 1, 1, 2])
    dst = torch.tensor([1, 1, 2, 0, 0, 0])
    x = ppr.ppr(src, dst, 3, 0, 0.5, 2)
    assert x.tolist() == pytest.approx([0.5, 0.5 * 0.5 * 2 / 3,
                                        0.5 * 0.5 / 3])


def test_references_import_nothing_of_the_program():
    for f in Path(bfs.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert (n.split(".")[0] in ("torch", "numpy", "__future__")
                        or n == "bench.reference"), (f, n)


@pytest.mark.parametrize("name", ["bfs", "sssp", "dist", "ppr"])
def test_each_kind_of_query_gives_what_the_check_reads(name):
    from bench.harness.spec import Spec
    kind = Spec().kind(name)
    assert kind.NUMBER.startswith(name + "_")
    assert int(kind.SAMPLE) >= 1
    for attr in ("combine", "reading", "control"):
        assert callable(getattr(kind, attr)), attr

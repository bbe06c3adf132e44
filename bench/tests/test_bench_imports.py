"""What a run loads: in a fresh process, importing the benchmark and
running a tiny loop through the port leaves no module whose top-level
name is ``jax``, ``jaxlib`` or ``repro`` (the JAX package); the plain
references load nothing of ``repro_torch``."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from conftest import ROOT, tiny_copy

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _fresh(code: str) -> set[str]:
    """Top-level names of the modules loaded after ``code`` runs in a
    new interpreter with the checkout's root and ``src`` on the path."""
    prog = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
    """) + textwrap.dedent(code) + textwrap.dedent("""
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_tiny_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    root = tiny_copy(tmp_path / "checkout")
    loaded = _fresh(f"""
        import torch
        torch.set_num_threads(1)
        from bench.harness import cell
        from bench.harness.spec import Spec
        for w in ("graph500-s21.bfs", "graph500-s21-serve.mixed-c32"):
            r = cell.run(w, 5, 0.3, False, device="cpu",
                         spec=Spec({str(root)!r}))
            assert r["correct"], r
    """)
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_run_entry_refuses_a_forbidden_module(monkeypatch):
    from bench.harness import cell
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert cell.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib")
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert cell.forbidden_modules() == ["repro"]


def test_the_port_passes_the_whole_name_check():
    from bench.harness import cell
    assert "repro_torch" not in cell.FORBIDDEN


def test_the_references_load_nothing_of_the_program():
    loaded = _fresh("""
        from bench.reference import bfs, dist, ppr, sssp
    """)
    assert "repro_torch" not in loaded and not loaded & FORBIDDEN

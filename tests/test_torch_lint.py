"""Port parity: the lint CLI (``python -m repro_torch.lint``) against
``repro.lint``.

The negative fixture is written into ``tmp_path`` in torch, modelled on
``tests/fixtures/bad_program.py`` (a BFS whose int32 sentinel wraps on
the gather's ``+ 1``), so no fixture of the JAX package is touched.
"""
import re
import subprocess
import sys
import textwrap

import pytest

from repro import lint as RL

from repro_torch import lint
from repro_torch.core import dsl

BAD_PROGRAM = textwrap.dedent('''
    """Known-bad vertex programs in the port's DSL."""
    import torch

    from repro_torch.core.dsl import VertexProgram

    # the sentinel at int32 max: ``+ 1`` wraps to -2**31 on the first
    # superstep and wins every ``min`` thereafter (A003, error)
    wrap_bfs = VertexProgram(
        name="wrap_bfs",
        gather=lambda v, w, d: v + 1,
        reduce="min",
        apply=torch.minimum,
        init_value=torch.iinfo(torch.int32).max,
        frontier="changed",
        value_dtype=torch.int32,
    )

    PROGRAMS = [wrap_bfs]
''')


def _tables(out: str) -> dict:
    """``{program: [codes]}`` from the CLI's printed tables."""
    tables, name = {}, None
    for line in out.splitlines():
        m = re.match(r"^(\w+):$", line)
        if m:
            name = m.group(1)
            tables[name] = []
        elif name is not None and re.match(r"^[AV]\d{3}\s", line):
            tables[name].append(line.split()[0])
    return tables


def test_lint_all_templates_exits_zero(capsys):
    assert lint.main(["--all"]) == 0
    out = capsys.readouterr().out
    assert "lint: OK" in out
    for name in dsl.PROGRAM_TEMPLATES:
        assert f"{name}:" in out


def test_lint_bad_module_exits_nonzero(tmp_path, capsys):
    path = tmp_path / "bad_program.py"
    path.write_text(BAD_PROGRAM)
    assert lint.main([str(path)]) == 1
    out = capsys.readouterr().out
    assert "A003" in out
    assert "lint: FAIL" in out
    assert _tables(out) == {"wrap_bfs": ["A003"]}


@pytest.mark.parametrize("argv", [["--all"],
                                  ["--all", "--pes", "2",
                                   "--message-dtype", "int8"]])
def test_lint_tables_list_the_jax_codes(argv, capsys):
    """Program for program, the port's tables list the codes
    ``repro.lint`` lists, and both exit alike."""
    rc = lint.main(argv)
    port = _tables(capsys.readouterr().out)
    rrc = RL.main(argv)
    ref = _tables(capsys.readouterr().out)
    assert rc == rrc == 0
    assert sorted(port) == sorted(dsl.PROGRAM_TEMPLATES)
    assert port == ref


def test_lint_missing_module_exits_two(capsys):
    assert lint.main(["no_such_module_for_lint"]) == 2
    assert "error:" in capsys.readouterr().err


def test_lint_runs_as_a_module(tmp_path):
    """``python -m repro_torch.lint`` on the bad module: exit 1, A003."""
    path = tmp_path / "bad_program.py"
    path.write_text(BAD_PROGRAM)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.lint",
                           str(path)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    assert "A003" in proc.stdout and "lint: FAIL" in proc.stdout

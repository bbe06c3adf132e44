"""Lint CLI: run the static analyzer over vertex programs, no graph needed.

Counterpart of ``repro.lint``.  Usage::

    python -m repro_torch.lint --all                 # every shipped template
    python -m repro_torch.lint mypkg.programs        # a user module (dotted)
    python -m repro_torch.lint path/to/programs.py   # ... or a file path
    python -m repro_torch.lint --all --pes 2 --message-dtype int8   # lint a
        # sharded, quantized deployment shape (engages the A006 rule)

A user module contributes programs through a module-level ``PROGRAMS``
iterable (of :class:`~repro_torch.core.dsl.VertexProgram` instances or
zero-arg factories returning one); without it, every module-level
``VertexProgram`` attribute is linted.

Each program is lowered to IR and run through the verified pass pipeline
against a synthetic 1,000-vertex / 10,000-edge plan: the analyzer needs
only the program, so linting touches no graph data and no device.  The
findings print as one table a program; the process exits 1 if any
finding reaches ``error`` severity (or a program fails IR verification or
construction), 0 otherwise: warnings are reported but do not fail the
lint, as ``translate(strict=False)``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys

__all__ = ["lint_program", "collect_programs", "main"]

# the synthetic schedule shape every lint run plans against
_LINT_VERTICES = 1000
_LINT_EDGES = 10_000


def lint_program(program, *, pes: int = 1, message_dtype: str | None = None,
                 num_vertices: int = _LINT_VERTICES,
                 num_edges: int = _LINT_EDGES):
    """Run the verified pass pipeline over ``program``; return diagnostics.

    Returns the full ``Diagnostic`` list (analyzer facts, lint rules and,
    should a pass misbehave, the verifier's ``V*`` findings: an
    :class:`~repro_torch.errors.IRVerificationError` is reported as its
    diagnostics rather than propagated, so one broken program cannot
    abort a multi-program lint run).  The plan is the plain PyTorch one
    (``use_kernels=False``) over ``pes`` PEs of the CPU repeated, so a
    sharded plan is linted with no card present.
    """
    from .core.ir import lower_program
    from .core.passes import PassContext, default_pipeline
    from .core.scheduler import ScheduleConfig, plan
    from .errors import IRVerificationError

    cfg = ScheduleConfig(pes=pes, message_dtype=message_dtype)
    splan = plan(cfg, num_vertices=num_vertices, num_edges=num_edges,
                 devices=["cpu"] * max(pes, 1))
    ctx = PassContext(schedule=cfg, plan=splan, use_kernels=False,
                      num_vertices=num_vertices, num_edges=num_edges)
    try:
        default_pipeline().run(lower_program(program), ctx, verify=True)
    except IRVerificationError:
        pass                       # the V* findings are already on ctx
    return list(ctx.diagnostics)


def _load_module(spec: str):
    """Import a lint target: dotted module name or a ``.py`` file path."""
    if spec.endswith(".py"):
        modspec = importlib.util.spec_from_file_location("_lint_target", spec)
        if modspec is None or modspec.loader is None:
            raise ImportError(f"cannot load {spec!r}")
        mod = importlib.util.module_from_spec(modspec)
        modspec.loader.exec_module(mod)
        return mod
    return importlib.import_module(spec)


def collect_programs(module) -> list:
    """``(name, program)`` pairs of a user module: its ``PROGRAMS``
    iterable first (programs or zero-arg factories), else every
    module-level :class:`~repro_torch.core.dsl.VertexProgram`."""
    from .core.dsl import VertexProgram

    entries = getattr(module, "PROGRAMS", None)
    out = []
    if entries is not None:
        for entry in entries:
            prog = entry() if callable(entry) \
                and not isinstance(entry, VertexProgram) else entry
            out.append((prog.name, prog))
        return out
    for attr in sorted(vars(module)):
        val = getattr(module, attr)
        if isinstance(val, VertexProgram):
            out.append((val.name, val))
    return out


def main(argv=None) -> int:
    from .core import dsl
    from .core.diagnostics import max_severity, render_table
    from .errors import ReproError

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static diagnostics for graph vertex programs.")
    target = ap.add_mutually_exclusive_group(required=True)
    target.add_argument("--all", action="store_true",
                        help="lint every shipped dsl.PROGRAM_TEMPLATES entry")
    target.add_argument("module", nargs="?",
                        help="dotted module name or .py path to lint")
    ap.add_argument("--pes", type=int, default=1,
                    help="lint against a sharded plan (default 1)")
    ap.add_argument("--message-dtype", default=None,
                    help="lint with exchange quantization (e.g. int8)")
    args = ap.parse_args(argv)

    if args.all:
        programs = list(dsl.PROGRAM_TEMPLATES.items())
    else:
        try:
            programs = collect_programs(_load_module(args.module))
        except (ImportError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not programs:
            print(f"error: no vertex programs found in {args.module!r}",
                  file=sys.stderr)
            return 2

    failed = False
    for name, prog in programs:
        try:
            if callable(prog):     # zero-arg template factory
                prog = prog()
            diags = lint_program(prog, pes=args.pes,
                                 message_dtype=args.message_dtype)
        except ReproError as e:
            # construction-time rejection (e.g. bfs_program's int_max guard)
            print(f"{name}: REJECTED at construction: {e}\n")
            failed = True
            continue
        print(render_table(diags, title=f"{name}:"))
        worst = max_severity(diags)
        if worst == "error":
            failed = True
        print(f"  -> {len(diags)} finding(s), worst severity: {worst}\n")

    print("lint: FAIL" if failed else "lint: OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

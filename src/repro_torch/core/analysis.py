"""Static program analysis over traced ATen graphs, and the IR verifier.

Counterpart of ``repro.core.analysis``.  Every legality decision the pass
pipeline makes about a user's ``gather``/``apply`` is decided by walking
the callable's traced graph rather than by sampling it:
:func:`analyze_program` traces both callables with
``torch.fx.experimental.proxy_tensor.make_fx`` on fake ``(8,)`` tensors
(the counterpart of ``jax.make_jaxpr`` on abstract avals), which gives
ATen-level nodes whatever Python spelling the user chose, and decides

* **gather module matching**: canonical-graph signature equality against
  the menu (``kernels.ref.gather_msg`` traced the same way), not numeric
  coincidence on a 16-element batch;
* **weight-use**: backward liveness of the weight placeholder;
* **elementwise-ness**: no cross-lane ATen op is live;
* **identity-fixpoint** / **identity-absorption**: abstract evaluation of
  the graph at the reduce identity over concrete tensors, symbolic
  input-plus-offset intervals and bounded intervals;
* **monotonicity under min/max reduces**: a clamp-shaped apply plus a
  sign-bounded gather offset proves values move one way only;
* **overflow**: integer folds are redone in int64, so ``gather(init)``
  wrapping int32 becomes the ``A003`` error.

Each fact records its **provenance**: ``'static'`` (decided from the
graph), ``'probed'`` (the callable could not be traced, or the abstract
domain was too coarse, so a sampling probe decided; an ``A001``
diagnostic says so) or ``'declined'`` (neither ran; the conservative
verdict).  Where both the graph and a probe reach a verdict they are
cross-checked: disagreement raises ``A002`` and the conservative verdict
wins.  A callable fails to trace when it needs concrete values (Python
control flow on a tensor, ``.item()``, a NumPy conversion), as a JAX
callable fails on a concretization error.

:func:`verify_ir` is the structural half: the pass pipeline runs it
between every pass pair under ``verify=True``.

Results are cached per program object, so repeat translations pay
nothing (:func:`analysis_cache_clear` drops them).
"""
from __future__ import annotations

import dataclasses
import math
import operator
from collections import OrderedDict
from functools import partial
from typing import Callable

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from ..kernels.ref import GATHER_OPS, WEIGHT_FREE_GATHERS, gather_msg
from .diagnostics import Diagnostic
from .dsl import VertexProgram, reduce_identity

__all__ = [
    "PropertyFact",
    "ProgramAnalysis",
    "analyze_program",
    "analysis_cache_clear",
    "verify_ir",
    "classify_gather",
    "apply_preserves_identity",
    "gather_absorbs_identity",
    "apply_is_elementwise",
    "apply_batches_over_lanes",
]

# Number of lanes traced; any small n > 1 works (the trace pins only dtype
# and rank).
_N = 8

# Finite stand-in for "any finite magnitude" in interval bounds.
_FIN = float(np.finfo(np.float64).max)

_COMMUTATIVE_REDUCES = ("add", "min", "max")

_PROVENANCES = ("static", "probed", "declined")


# ---------------------------------------------------------------------------
# Result types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PropertyFact:
    """One analyzed property: its verdict and how it was reached
    (``'static'``, ``'probed'`` or ``'declined'``, see the module
    docstring); ``detail`` is a short justification."""

    value: object
    provenance: str
    detail: str = ""

    def __post_init__(self):
        if self.provenance not in _PROVENANCES:
            raise ValueError(f"unknown provenance: {self.provenance!r}")


@dataclasses.dataclass(frozen=True)
class ProgramAnalysis:
    """All analyzed facts for one :class:`~repro_torch.core.dsl.VertexProgram`.

    ``gather_module`` feeds gather classification, ``weight_use`` the
    pull sweep's table mode, ``elementwise`` superstep fusion,
    ``identity_fixpoint`` the push layout and touched-mask elision,
    ``identity_absorbing`` the masked sweep, and ``monotone`` is
    termination evidence for ``'changed'``-frontier programs.
    ``diagnostics`` carries the program-level findings.
    """

    gather_module: PropertyFact      # str | None
    weight_use: PropertyFact         # bool
    elementwise: PropertyFact        # bool
    identity_fixpoint: PropertyFact  # bool
    identity_absorbing: PropertyFact # bool
    monotone: PropertyFact           # bool
    diagnostics: tuple = ()

    def summary(self) -> dict:
        """``{property: (value, provenance)}``."""
        return {
            f.name: (getattr(self, f.name).value,
                     getattr(self, f.name).provenance)
            for f in dataclasses.fields(self)
            if f.name != "diagnostics"
        }


# ---------------------------------------------------------------------------
# Tracing and canonical signatures
# ---------------------------------------------------------------------------


def _trace(fn: Callable, *examples):
    """``make_fx`` on fake tensors shaped like ``examples``; ``None`` if
    the callable cannot be traced.  A user callable can raise anything
    while it is traced, so every exception means "untraceable"."""
    try:
        return make_fx(fn, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*examples)
    except Exception:
        return None


def _gather_examples(dtype: torch.dtype):
    # the weight takes the value dtype, as the resident engine passes it
    # (``wgt.to(v.dtype)``) and the JAX package traces it
    return (torch.zeros(_N, dtype=dtype), torch.zeros(_N, dtype=dtype),
            torch.zeros(_N, dtype=torch.int32))  # (values, weights, degrees)


def _apply_examples(dtype: torch.dtype):
    return torch.zeros(_N, dtype=dtype), torch.zeros(_N, dtype=dtype)


def _op_name(node) -> str:
    """The ATen op's name without its overload (``'add'`` for
    ``aten.add.Tensor``), ``'getitem'`` for a tuple index."""
    target = node.target
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else repr(target)


def _meta(node):
    """The fake value make_fx recorded for ``node`` (a tensor, a tuple)."""
    return node.meta.get("val")


def _aval(node) -> str:
    val = _meta(node)
    if isinstance(val, torch.Tensor):
        return f"{str(val.dtype).removeprefix('torch.')}{list(val.shape)}"
    return type(val).__name__


def _const_repr(val) -> str:
    a = val.detach().cpu() if isinstance(val, torch.Tensor) \
        else torch.as_tensor(val)
    if a.numel() <= 16:
        return f"c({a.dtype}:{tuple(a.shape)}:{a.tolist()})"
    raw = a.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return f"c({a.dtype}:{tuple(a.shape)}:#{hash(raw)})"


def _param_repr(val, vname) -> str:
    if isinstance(val, torch.fx.Node):
        return vname(val)
    if isinstance(val, (tuple, list)):
        return "(" + ",".join(_param_repr(v, vname) for v in val) + ")"
    if isinstance(val, torch.Tensor):
        return _const_repr(val)
    if isinstance(val, (bool, int, float)):
        return f"{type(val).__name__}:{val!r}"
    return repr(val)


# Two-operand ops whose operand order is semantically irrelevant: their
# operand reprs are sorted so ``a + b`` and ``b + a`` match.
_COMMUTATIVE_OPS = frozenset([
    "add", "mul", "minimum", "maximum", "eq", "ne", "bitwise_and",
    "bitwise_or", "bitwise_xor", "logical_and", "logical_or", "logical_xor"])


def _signature(gm) -> str:
    """Canonical text of a traced graph under sequential renaming:
    constants in by value, commutative operands sorted."""
    names: dict = {}

    def vname(n):
        if n not in names:
            names[n] = f"v{len(names)}"
        return names[n]

    ins, parts = [], []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            ins.append(f"{vname(node)}:{_aval(node)}")
        elif node.op == "get_attr":
            parts.append(f"const {vname(node)}="
                         + _const_repr(getattr(gm, node.target)))
        elif node.op == "call_function":
            args = [_param_repr(a, vname) for a in node.args]
            if _op_name(node) in _COMMUTATIVE_OPS and len(args) == 2 \
                    and node.kwargs.get("alpha", 1) == 1:
                args = sorted(args)
            kwargs = ",".join(f"{k}={_param_repr(v, vname)}"
                              for k, v in sorted(node.kwargs.items()))
            parts.append(f"{vname(node)} = {node.target}[{kwargs}] "
                         + ",".join(args))
        elif node.op == "output":
            parts.append("out " + _param_repr(node.args[0], vname))
    return "; ".join(["in " + ",".join(ins)] + parts)


_MENU_SIG_CACHE: dict = {}


def _menu_signatures(dtype: torch.dtype) -> dict:
    """``{canonical signature: module name}`` for the menu, per dtype."""
    if dtype not in _MENU_SIG_CACHE:
        sigs = {}
        for name in GATHER_OPS:
            gm = _trace(partial(gather_msg, name), *_gather_examples(dtype))
            if gm is not None:
                sigs[_signature(gm)] = name
        _MENU_SIG_CACHE[dtype] = sigs
    return _MENU_SIG_CACHE[dtype]


# ---------------------------------------------------------------------------
# Liveness (which placeholders reach the output)
# ---------------------------------------------------------------------------

# Ops that read only their first operand's shape and dtype, never its
# values (``ones_like(v)`` is JAX's ``broadcast_in_dim`` of a literal).
_SHAPE_ONLY = frozenset(["ones_like", "zeros_like", "full_like",
                         "new_ones", "new_zeros", "new_full"])


def _data_inputs(node) -> list:
    inputs = node.all_input_nodes
    if node.op == "call_function" and _op_name(node) in _SHAPE_ONLY \
            and node.args and isinstance(node.args[0], torch.fx.Node):
        inputs = [n for n in inputs if n is not node.args[0]]
    return inputs


def _output_node(gm):
    return next(n for n in reversed(gm.graph.nodes) if n.op == "output")


def _live_nodes(gm):
    """The call nodes whose values (transitively) reach the output, in
    graph order, and every node they read."""
    out = _output_node(gm)
    live_vars = set(out.all_input_nodes)
    live = []
    for node in reversed(list(gm.graph.nodes)):
        if node in live_vars:
            live_vars.update(_data_inputs(node))
            if node.op == "call_function":
                live.append(node)
    live.reverse()
    return live, live_vars


def _uses_placeholder(gm, index: int) -> bool:
    """Backward liveness: does the ``index``-th input reach the output?"""
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    _, live_vars = _live_nodes(gm)
    return placeholders[index] in live_vars


# ---------------------------------------------------------------------------
# Elementwise-ness (cross-lane op walk)
# ---------------------------------------------------------------------------

# Ops that act independently on each lane of the vertex axis (output lane
# i depends only on operand lanes i, the same way at every i).  As in the
# JAX package, position-dependent ops (``arange``: "which lane am I?") are
# excluded though they read no other lane: the fused superstep tiles the
# vertex axis and only a position-independent apply commutes with that.
_LANEWISE = frozenset([
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "pow", "neg",
    "sign", "sgn", "floor", "ceil", "round", "trunc", "frac", "abs", "exp",
    "exp2", "log", "log2", "log10", "log1p", "expm1", "sqrt", "rsqrt",
    "reciprocal", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "sigmoid", "erf",
    "erfc", "erfinv", "minimum", "maximum", "fmin", "fmax", "clamp",
    "clamp_min", "clamp_max", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
    "logical_and", "logical_or", "logical_xor", "logical_not", "eq", "ne",
    "lt", "le", "gt", "ge", "where", "_to_copy", "clone", "alias", "detach",
    "lift_fresh_copy", "copy", "isfinite", "isnan", "isinf", "nextafter",
    "square", "floor_divide", "hypot", "copysign", "signbit", "nan_to_num",
    "relu", "masked_fill", "scalar_tensor", "full", "ones", "zeros",
    *_SHAPE_ONLY,
])

# Ops that mix lanes, change the lane structure or read the lane position:
# any live occurrence refutes elementwise-ness outright.
_CROSS_LANE = frozenset([
    "arange", "sum", "prod", "mean", "amax", "amin", "max", "min", "argmax",
    "argmin", "any", "all", "var", "std", "var_mean", "std_mean", "norm",
    "linalg_vector_norm", "logsumexp", "_softmax", "_log_softmax",
    "count_nonzero", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "sort", "argsort", "topk", "kthvalue", "median", "mode",
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "_unsafe_index", "index_select", "index_put", "index_add", "index_copy",
    "index_fill", "index_reduce", "take", "masked_select", "nonzero",
    "unique_dim", "_unique2", "unique_consecutive", "flip", "roll", "rot90",
    "cat", "stack", "constant_pad_nd", "pad", "slice", "select", "narrow",
    "diff", "repeat", "tril", "triu", "searchsorted", "bincount", "histc",
    "mm", "mv", "dot", "bmm", "matmul", "convolution", "_fft_r2c",
    "_fft_c2r", "_fft_c2c", "randperm",
])


def _walk_elementwise(gm) -> bool | None:
    """``True`` every live op lanewise, ``False`` a cross-lane op is live,
    ``None`` an unclassified op appeared (undecided)."""
    live, _ = _live_nodes(gm)
    undecided = False
    for node in live:
        name = _op_name(node)
        if name in _CROSS_LANE:
            return False
        if name in _LANEWISE:
            continue
        if name == "expand":
            # scalar → vector (a constant per lane) is lanewise; anything
            # reshaping an existing vector axis is not provably so
            src, out = _meta(node.args[0]), _meta(node)
            if src.dim() == 0 or src.shape == out.shape:
                continue
        undecided = True                 # unknown op: punt to the probe
    return None if undecided else True


def _static_elementwise(gm) -> bool | None:
    out = _output_node(gm).args[0]
    if not isinstance(out, torch.fx.Node) \
            or not isinstance(_meta(out), torch.Tensor) \
            or tuple(_meta(out).shape) != (_N,):
        return False                     # shape change is never elementwise
    return _walk_elementwise(gm)


# ---------------------------------------------------------------------------
# Abstract interpreter (symbolic evaluation at the reduce identity)
# ---------------------------------------------------------------------------


class _Top:
    """Unknown value (abstract ⊤)."""

    def __repr__(self):
        return "⊤"


_TOP = _Top()


@dataclasses.dataclass(frozen=True)
class _Aff:
    """``input[var] + δ`` with the additive offset δ ∈ ``[lo, hi]``."""

    var: int
    lo: float
    hi: float


@dataclasses.dataclass(frozen=True)
class _Rng:
    """Unknown value bounded to ``[lo, hi]`` (per lane)."""

    lo: float
    hi: float


class _EvalState:
    """Per-evaluation flags: opacity and detected integer wraparound."""

    def __init__(self):
        self.opaque = False              # hit an op we cannot model
        self.wrapped = False             # an integer fold over/underflowed


def _is_conc(x) -> bool:
    """A concrete value: a real tensor or a Python number."""
    return isinstance(x, (torch.Tensor, bool, int, float))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _any(x) -> bool:
    return bool(_as_tensor(x).any())


def _all_nonfinite(x) -> bool:
    t = _as_tensor(x)
    return t.dtype.is_floating_point and bool((~torch.isfinite(t)).all())


def _uniform_scalar(a):
    """The scalar ``c`` if every element of ``a`` equals ``c``, else None."""
    flat = _as_tensor(a).reshape(-1)
    if flat.numel() == 0:
        return None
    c = flat[0]
    return c.item() if bool((flat == c).all()) else None


def _bounds(x) -> tuple[float, float] | None:
    """Interval bounds of a non-symbolic abstract value, if known."""
    if _is_conc(x):
        t = _as_tensor(x)
        if t.numel() == 0:
            return None
        t = t.to(torch.float64)
        return float(t.min()), float(t.max())
    if isinstance(x, _Rng):
        return x.lo, x.hi
    return None


def _int_dtype(dtype) -> torch.dtype | None:
    """``dtype`` if it is an integer type narrower than 64 bits."""
    if isinstance(dtype, torch.dtype) and not dtype.is_floating_point \
            and not dtype.is_complex and dtype != torch.bool \
            and dtype.itemsize < 8:
        return dtype
    return None


def _out_of_range(lo: float, hi: float, int_dtype) -> bool:
    info = torch.iinfo(int_dtype)
    return lo < info.min or hi > info.max


def _widen(a):
    """A concrete integer operand in int64, for the wraparound re-check."""
    if isinstance(a, torch.Tensor) and _int_dtype(a.dtype) is not None:
        return a.to(torch.int64)
    return a


_WRAP_CHECKED = ("add", "sub", "rsub", "mul")


def _fold(node, args, kwargs, state: _EvalState):
    """Concretely evaluate one node; flags integer wraparound."""
    try:
        out = node.target(*args, **kwargs)
    except Exception:                    # an op the real kernel refuses
        state.opaque = True
        return _TOP
    if _op_name(node) in _WRAP_CHECKED and isinstance(out, torch.Tensor) \
            and _int_dtype(out.dtype) is not None:
        wide = node.target(*[_widen(a) for a in args], **kwargs)
        if not torch.equal(out.to(torch.int64), wide.to(torch.int64)):
            state.wrapped = True
    return out


def _add_rule(a, b, sign: int, state: _EvalState, int_dtype):
    """Abstract ``a + sign*b`` (sign=-1 for sub)."""
    if isinstance(a, _Aff) and (bnds := _bounds(b)) is not None:
        lo, hi = bnds
        if sign < 0:
            lo, hi = -hi, -lo
        return _Aff(a.var, a.lo + lo, a.hi + hi)
    if isinstance(b, _Aff) and sign > 0 and (bnds := _bounds(a)) is not None:
        return _Aff(b.var, b.lo + bnds[0], b.hi + bnds[1])
    ba, bb = _bounds(a), _bounds(b)
    if ba is not None and bb is not None:
        # ±inf + finite stays ±inf; inf - inf is unknowable
        lo = ba[0] + sign * (bb[1] if sign < 0 else bb[0])
        hi = ba[1] + sign * (bb[0] if sign < 0 else bb[1])
        if math.isnan(lo) or math.isnan(hi):
            return _TOP
        if int_dtype is not None and _out_of_range(lo, hi, int_dtype):
            state.wrapped = True
            return _TOP
        # a concrete ±inf array shifted by a finite interval is unchanged
        finite_b = math.isfinite(bb[0]) and math.isfinite(bb[1])
        finite_a = math.isfinite(ba[0]) and math.isfinite(ba[1])
        if _is_conc(a) and _all_nonfinite(a) and finite_b:
            return a
        if _is_conc(b) and sign > 0 and _all_nonfinite(b) and finite_a:
            return b
        return _Rng(lo, hi)
    return _TOP


def _mul_rule(a, b, state: _EvalState, int_dtype):
    ba, bb = _bounds(a), _bounds(b)
    if ba is None or bb is None:
        # x * 1 (exactly) passes an _Aff through
        for sym, conc in ((a, b), (b, a)):
            if isinstance(sym, _Aff) and _is_conc(conc) \
                    and _uniform_scalar(conc) == 1:
                return sym
        return _TOP
    # all-zero concrete × any finite interval is zero
    for z, obnds in ((a, bb), (b, ba)):
        if _is_conc(z) and not _any(z) and math.isfinite(obnds[0]) \
                and math.isfinite(obnds[1]):
            return z
    cands = [ba[0] * bb[0], ba[0] * bb[1], ba[1] * bb[0], ba[1] * bb[1]]
    if any(math.isnan(c) for c in cands):
        return _TOP
    lo, hi = min(cands), max(cands)
    if int_dtype is not None and _out_of_range(lo, hi, int_dtype):
        state.wrapped = True
        return _TOP
    return _Rng(lo, hi)


def _div_rule(a, b, out_dtype, rounding):
    ba, bb = _bounds(a), _bounds(b)
    if ba is None or bb is None:
        return _TOP
    if _is_conc(a) and not _any(a) and bb[0] > 0:
        return _as_tensor(a).to(out_dtype)     # 0 / positive = 0
    if bb[0] > 0 or bb[1] < 0:           # denominator excludes zero
        cands = [ba[0] / bb[0], ba[0] / bb[1], ba[1] / bb[0], ba[1] / bb[1]]
        if any(math.isnan(c) for c in cands):
            return _TOP
        lo, hi = min(cands), max(cands)
        if rounding is not None:         # floor or trunc stays in [⌊lo⌋, ⌈hi⌉]
            lo, hi = math.floor(lo), math.ceil(hi)
        return _Rng(lo, hi)
    return _TOP


def _minmax_rule(name: str, a, b, out_dtype):
    pick = min if name == "min" else max
    # x clamped against the reduce identity of its own extreme is x
    for sym, conc in ((a, b), (b, a)):
        if isinstance(sym, _Aff) and _is_conc(conc):
            c = _uniform_scalar(conc)
            if c is not None:
                if out_dtype.is_floating_point:
                    neutral = math.inf if name == "min" else -math.inf
                else:
                    info = torch.iinfo(out_dtype)
                    neutral = info.max if name == "min" else info.min
                if c == neutral:
                    return sym
            return _TOP                  # a real clamp of an unknown base
    if isinstance(a, _Aff) and isinstance(b, _Aff) and a.var == b.var:
        return _Aff(a.var, pick(a.lo, b.lo), pick(a.hi, b.hi))
    ba, bb = _bounds(a), _bounds(b)
    if ba is not None and bb is not None:
        return _Rng(pick(ba[0], bb[0]), pick(ba[1], bb[1]))
    return _TOP


_COMPARISONS = frozenset(["eq", "ne", "lt", "le", "gt", "ge"])
_COPIES = frozenset(["clone", "alias", "detach", "lift_fresh_copy"])


def _eval_call(node, ins, out_dtype, state: _EvalState):
    """One abstract op over the operands ``ins`` (``node.args`` with the
    graph's values in place of its nodes)."""
    name = _op_name(node)
    int_dtype = _int_dtype(out_dtype)
    if name in ("add", "sub", "rsub"):
        a, b = ins[0], ins[1]
        if name == "rsub":               # rsub(x, c) = c - alpha * x
            a, b = b, a
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            b = _mul_rule(b, alpha, state, int_dtype)
        return _add_rule(a, b, 1 if name == "add" else -1, state, int_dtype)
    if name == "mul":
        return _mul_rule(ins[0], ins[1], state, int_dtype)
    if name == "div":
        return _div_rule(ins[0], ins[1], out_dtype,
                         node.kwargs.get("rounding_mode"))
    if name in ("minimum", "maximum"):
        return _minmax_rule(name[:3], ins[0], ins[1], out_dtype)
    if name in ("clamp_min", "clamp_max"):
        return _minmax_rule("max" if name == "clamp_min" else "min",
                            ins[0], ins[1], out_dtype)
    if name == "clamp":
        x = ins[0]
        lo = ins[1] if len(ins) > 1 else None
        hi = ins[2] if len(ins) > 2 else None
        if lo is not None:
            x = _minmax_rule("max", x, lo, out_dtype)
        if hi is not None:
            x = _minmax_rule("min", x, hi, out_dtype)
        return x
    if name == "neg":
        b = _bounds(ins[0])
        return _Rng(-b[1], -b[0]) if b is not None \
            and not _is_conc(ins[0]) else _TOP
    if name == "_to_copy":
        x = ins[0]
        src = _meta(node.args[0]).dtype
        if isinstance(x, _Aff):
            return x if src == out_dtype else _TOP
        return x if isinstance(x, _Rng) else _TOP   # bounds survive a cast
    if name == "expand":
        x = ins[0]
        return x if isinstance(x, (_Rng, _Aff)) else _TOP
    if name in _COPIES:
        return ins[0]
    if name == "where":
        branches = ins[1:]
        if all(_is_conc(b) for b in branches) and all(
                torch.equal(_as_tensor(b), _as_tensor(branches[0]))
                for b in branches[1:]):
            return branches[0]
        if not _is_conc(branches[0]) and all(
                isinstance(b, type(branches[0])) and b == branches[0]
                for b in branches[1:]):
            return branches[0]
        return _TOP
    if name in _COMPARISONS:
        return _Rng(0.0, 1.0)            # unknown predicate, bounded bool
    state.opaque = True
    return _TOP


def _eval_graph(gm, args, state: _EvalState):
    """Abstractly evaluate a traced graph over the concrete / _Aff / _Rng /
    ⊤ domain; returns the single output's value (⊤ for several)."""
    env: dict = {}
    placeholders = iter(args)

    def read(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (tuple, list)):
            return type(a)(read(x) for x in a)
        return a

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(placeholders)
        elif node.op == "get_attr":
            env[node] = getattr(gm, node.target)
        elif node.op == "output":
            out = read(node.args[0])
            if isinstance(out, (bool, int, float)):
                return torch.as_tensor(out)
            return out if _is_conc(out) or isinstance(out, (_Aff, _Rng)) \
                else _TOP
        elif node.target is operator.getitem:
            seq = env[node.args[0]]
            env[node] = seq[node.args[1]] \
                if isinstance(seq, (tuple, list)) else _TOP
        else:
            ins = [read(a) for a in node.args]
            kwargs = {k: read(v) for k, v in node.kwargs.items()}
            operands = [env[n] for n in node.all_input_nodes]
            if all(_is_conc(x) or isinstance(x, (tuple, list))
                   for x in operands):
                env[node] = _fold(node, ins, kwargs, state)
                continue
            if _op_name(node) in _SHAPE_ONLY:
                # the value never depends on the first operand's values
                ins[0] = torch.zeros(_meta(node.args[0]).shape,
                                     dtype=_meta(node.args[0]).dtype)
                env[node] = _fold(node, ins, kwargs, state)
                continue
            val = _meta(node)
            if isinstance(val, torch.Tensor):
                env[node] = _eval_call(node, ins, val.dtype, state)
            else:                        # a tuple-valued op (sort, max.dim)
                state.opaque = True
                env[node] = _TOP
    return _TOP


# ---------------------------------------------------------------------------
# Sampling probes (the fallback tier and the static tier's cross-check)
# ---------------------------------------------------------------------------


def _weight_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _batch(values, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values)).to(dtype)


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-level agreement for the probes (NaN equals NaN)."""
    return a.shape == b.shape and bool(
        np.array_equal(a.numpy(), b.numpy(), equal_nan=True))


def classify_gather(gather: Callable, dtype: torch.dtype) -> str | None:
    """Match a gather callable against the menu by sampling probe.

    Evaluates the gather on a fixed random batch and compares against
    every menu entry (``kernels.ref.GATHER_OPS``); returns the matched
    module name, or ``None`` for the general path.  Numeric coincidence on
    the batch does not decide the module on its own: it is the fallback
    for an untraceable gather and a cross-check on the graph signature
    (:func:`analyze_program`).
    """
    rng = np.random.default_rng(0)
    v = _batch(rng.uniform(1, 8, (16,)), dtype)
    w = _batch(rng.uniform(1, 8, (16,)), _weight_dtype(dtype)).to(dtype)
    d = _batch(rng.integers(1, 9, (16,)), torch.int32)
    try:
        got = gather(v, w, d).numpy()
    except Exception:
        return None
    for name in GATHER_OPS:
        want = gather_msg(name, v, w, d).numpy()
        if got.shape == want.shape and np.allclose(got, want, rtol=1e-5,
                                                   atol=1e-5):
            return name
    return None


def apply_preserves_identity(apply: Callable, reduce: str,
                             dtype: torch.dtype) -> bool:
    """Probe whether ``apply(x, identity) == x`` bit-exactly.

    When it holds an untouched vertex is a fixpoint of the superstep, so
    the push engine applies the reduced table everywhere and skips the
    touched mask.
    """
    ident = reduce_identity(reduce, dtype)
    rng = np.random.default_rng(0)
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
        probes = np.concatenate([
            rng.uniform(-8, 8, 13), [0.0, info.max / 2, -info.max / 2]])
    else:
        info = torch.iinfo(dtype)
        probes = np.concatenate([
            rng.integers(-8, 8, 13), [0, info.max - 1, info.min + 1]])
    x = _batch(probes, dtype)
    try:
        got = apply(x, torch.full_like(x, ident.item()))
    except Exception:
        return False
    return _equal(got, x)


def gather_absorbs_identity(gather: Callable, reduce: str,
                            dtype: torch.dtype) -> bool:
    """Probe whether ``gather(identity, w, d) == identity`` for any
    weight and degree (SSSP: ``inf + w == inf``)."""
    ident = reduce_identity(reduce, dtype)
    rng = np.random.default_rng(2)
    w = _batch(rng.uniform(-8, 8, (16,)), _weight_dtype(dtype)).to(dtype)
    d = _batch(rng.integers(1, 9, (16,)), torch.int32)
    x = torch.full((16,), ident.item(), dtype=dtype)
    try:
        got = gather(x, w, d)
    except Exception:
        return False
    return _equal(got, torch.full((16,), ident.item(), dtype=dtype))


def apply_is_elementwise(apply: Callable, dtype: torch.dtype) -> bool:
    """Probe whether output ``i`` of ``apply`` depends only on
    ``(old[i], reduced[i])``: shape preservation, per-element agreement,
    and locality under a one-slot perturbation."""
    rng = np.random.default_rng(1)
    n = 8
    if dtype.is_floating_point:
        xs = rng.uniform(-8, 8, (2, n))
    else:
        xs = rng.integers(-8, 8, (2, n))
    x = _batch(xs[0], dtype)
    r = _batch(xs[1], dtype)
    try:
        full = apply(x, r)
        if full.shape != (n,):
            return False
        per = torch.stack([apply(x[i:i + 1], r[i:i + 1])[0]
                           for i in range(n)])
        if not _equal(full, per):
            return False
        for k in (0, n - 1):
            x2, r2 = x.clone(), r.clone()
            x2[k] += 1
            r2[k] += 1
            out2 = apply(x2, r2)
            others = torch.arange(n) != k
            if not _equal(full[others], out2[others]):
                return False
    except Exception:
        return False
    return True


def apply_batches_over_lanes(apply: Callable, dtype: torch.dtype,
                             num_vertices: int) -> bool:
    """Probe whether ``apply`` on a ``(2, V)`` batch of lanes gives each
    lane what it gives that lane alone, at the graph's own ``V``.

    The lane API runs an apply that passes this once on a whole batch of
    lanes, and any other lane by lane.  The 1-D elementwise probe alone is
    not enough: an apply that reads the length of its input (ppr's
    restart vector, ``arange(s.shape[0]) == root``) looks elementwise on
    8 probe slots for a root past them, and reads the lane count on a
    batch.
    """
    rng = np.random.default_rng(2)
    shape = (2, max(int(num_vertices), 1))
    if dtype.is_floating_point:
        xs = rng.uniform(-8, 8, (2, *shape))
    else:
        xs = rng.integers(-8, 8, (2, *shape))
    x = _batch(xs[0], dtype)
    r = _batch(xs[1], dtype)
    try:
        both = apply(x, r)
        per = torch.stack([apply(x[i], r[i]) for i in range(2)])
    except Exception:
        return False
    return _equal(both, per)


# ---------------------------------------------------------------------------
# Property deciders (static first, probe as fallback and cross-check)
# ---------------------------------------------------------------------------


def _identity_full(program: VertexProgram) -> torch.Tensor:
    ident = reduce_identity(program.reduce, program.value_dtype)
    return torch.full((_N,), ident.item(), dtype=ident.dtype)


def _decide_module(program, gather_gm, diags) -> PropertyFact:
    probe = classify_gather(program.gather, program.value_dtype)
    if gather_gm is None:
        if probe is None:
            return PropertyFact(None, "declined",
                                "gather untraceable and probe matched nothing")
        diags.append(Diagnostic(
            "A001", "info", "gather",
            f"module match {probe!r} rests on a 16-element sampling probe "
            "(gather is opaque to make_fx tracing)",
            "prefer traceable gathers so the match is proved, not sampled"))
        return PropertyFact(probe, "probed",
                            f"probe matched {probe!r} (graph opaque)")
    static = _menu_signatures(program.value_dtype).get(_signature(gather_gm))
    if static is None and probe is not None:
        diags.append(Diagnostic(
            "A002", "warning", "gather",
            f"sampling probe matched module {probe!r} but the gather's "
            "graph is not that module — numeric coincidence on the probe "
            "batch; the general path is used",
            "if the gather really is the menu op, write it in the menu "
            "form so the signatures align"))
    detail = (f"canonical graph signature matched {static!r}" if static
              else "canonical graph signature matched no menu module")
    return PropertyFact(static, "static", detail)


def _decide_weight_use(program, gather_gm) -> PropertyFact:
    if gather_gm is not None:
        used = _uses_placeholder(gather_gm, 1)
        return PropertyFact(
            used, "static",
            "weight argument is " + ("live in" if used else "dead in")
            + " the gather graph")
    probe = classify_gather(program.gather, program.value_dtype)
    if probe is not None:
        return PropertyFact(probe not in WEIGHT_FREE_GATHERS, "probed",
                            f"inferred from probe-matched module {probe!r}")
    return PropertyFact(True, "declined",
                        "gather untraceable; conservatively weight-using")


def _decide_elementwise(program, apply_gm, diags) -> PropertyFact:
    probe_ok = None

    def probe():
        nonlocal probe_ok
        if probe_ok is None:
            probe_ok = apply_is_elementwise(program.apply,
                                            program.value_dtype)
        return probe_ok

    if apply_gm is None:
        diags.append(Diagnostic(
            "A001", "info", "apply",
            "elementwise-ness decided by sampling probe only (apply is "
            "opaque to make_fx tracing)",
            "prefer traceable applies so fusion legality is proved"))
        return PropertyFact(probe(), "probed", "apply graph opaque")
    static = _static_elementwise(apply_gm)
    if static is None:
        diags.append(Diagnostic(
            "A001", "info", "apply",
            "elementwise-ness decided by sampling probe (an unclassified "
            "op appears in the apply graph)", ""))
        return PropertyFact(probe(), "probed",
                            "unclassified op in the apply graph")
    if static is False and probe():
        diags.append(Diagnostic(
            "A002", "warning", "apply",
            "sampling probe calls the apply elementwise but its graph "
            "contains a cross-lane op — the probe batch missed the mixing; "
            "fusion is declined", ""))
    return PropertyFact(
        static, "static",
        "live apply ops are all lanewise" if static
        else "a cross-lane op is live in the apply graph")


def _decide_fixpoint(program, apply_gm, diags) -> PropertyFact:
    probe_val = apply_preserves_identity(program.apply, program.reduce,
                                         program.value_dtype)
    if apply_gm is None:
        diags.append(Diagnostic(
            "A001", "info", "apply",
            "identity-fixpoint decided by sampling probe only (apply is "
            "opaque to make_fx tracing)", ""))
        return PropertyFact(probe_val, "probed", "apply graph opaque")
    out = _eval_graph(apply_gm, [_Aff(0, 0.0, 0.0), _identity_full(program)],
                      _EvalState())
    if isinstance(out, _Aff) and out.var == 0 and out.lo == 0 == out.hi:
        static, detail = True, "apply(x, identity) reduces to x symbolically"
    elif isinstance(out, _Aff) and (out.lo > 0 or out.hi < 0):
        static, detail = False, "apply(x, identity) is x plus a nonzero offset"
    elif _is_conc(out) or isinstance(out, _Rng):
        static, detail = False, \
            "apply(x, identity) is independent of x (cannot equal x for all x)"
    else:
        static, detail = None, "symbolic evaluation too coarse"
    if static is None:
        diags.append(Diagnostic(
            "A001", "info", "apply",
            "identity-fixpoint decided by sampling probe (symbolic "
            "evaluation of the apply at the identity was inconclusive)", ""))
        return PropertyFact(probe_val, "probed", detail)
    if static != probe_val:
        diags.append(Diagnostic(
            "A002", "warning", "apply",
            f"identity-fixpoint: probe says {probe_val}, static evaluation "
            f"says {static} — conservative verdict "
            f"{static and probe_val} is used", ""))
        return PropertyFact(static and probe_val, "static",
                            detail + " (probe disagreed)")
    return PropertyFact(static, "static", detail)


def _decide_absorbing(program, gather_gm, diags) -> PropertyFact:
    probe_val = gather_absorbs_identity(program.gather, program.reduce,
                                        program.value_dtype)
    if gather_gm is None:
        diags.append(Diagnostic(
            "A001", "info", "gather",
            "identity-absorption decided by sampling probe only (gather is "
            "opaque to make_fx tracing)", ""))
        return PropertyFact(probe_val, "probed", "gather graph opaque")
    ident = _identity_full(program)
    out = _eval_graph(gather_gm, [ident, _Rng(-_FIN, _FIN),
                                  _Rng(1.0, float(2**31 - 1))], _EvalState())
    iscalar = ident[0].item()
    if _is_conc(out):
        static = _equal(out, ident.to(out.dtype))
        detail = ("gather(identity, w, d) folds to the identity" if static
                  else "gather(identity, w, d) folds to a non-identity value")
    elif isinstance(out, _Rng):
        if out.lo == out.hi == iscalar:
            static, detail = True, "gather(identity) is pinned to the identity"
        elif iscalar < out.lo or iscalar > out.hi:
            static, detail = False, \
                "gather(identity) is bounded away from the identity"
        else:
            static, detail = None, "interval bounds straddle the identity"
    else:
        static, detail = None, "symbolic evaluation too coarse"
    if static is None:
        diags.append(Diagnostic(
            "A001", "info", "gather",
            "identity-absorption decided by sampling probe (symbolic "
            "evaluation of the gather at the identity was inconclusive)", ""))
        return PropertyFact(probe_val, "probed", detail)
    if static != probe_val:
        diags.append(Diagnostic(
            "A002", "warning", "gather",
            f"identity-absorption: probe says {probe_val}, static "
            f"evaluation says {static} — conservative verdict "
            f"{static and probe_val} is used", ""))
        return PropertyFact(static and probe_val, "static",
                            detail + " (probe disagreed)")
    return PropertyFact(static, "static", detail)


def _apply_is_clamp(apply_gm, reduce: str) -> bool:
    """Structurally: is the apply exactly ``minimum/maximum(old, reduced)``?"""
    if apply_gm is None or reduce not in ("min", "max"):
        return False
    live, _ = _live_nodes(apply_gm)
    out = _output_node(apply_gm).args[0]
    if len(live) != 1 or live[0] is not out:
        return False
    node = live[0]
    if _op_name(node) != {"min": "minimum", "max": "maximum"}[reduce]:
        return False
    placeholders = {n for n in apply_gm.graph.nodes if n.op == "placeholder"}
    return all(isinstance(a, torch.fx.Node) for a in node.args) \
        and set(node.args) == placeholders


def _decide_monotone(program, gather_gm, apply_gm) -> PropertyFact:
    if program.reduce not in ("min", "max"):
        return PropertyFact(
            False, "static",
            f"reduce '{program.reduce}' has no monotone-convergence "
            "argument (only min/max clamp the value lattice)")
    if not _apply_is_clamp(apply_gm, program.reduce):
        prov = "static" if apply_gm is not None else "declined"
        return PropertyFact(False, prov,
                            "apply is not the reduce's clamp "
                            f"({program.reduce}(old, reduced))")
    if gather_gm is None:
        return PropertyFact(False, "declined",
                            "gather untraceable; no offset-sign evidence")
    # non-negative weights: validate_graph's per-reduce weight-domain check
    out = _eval_graph(gather_gm, [_Aff(0, 0.0, 0.0), _Rng(0.0, _FIN),
                                  _Rng(1.0, float(2**31 - 1))], _EvalState())
    if isinstance(out, _Aff) and out.var == 0:
        ok = out.lo >= 0 if program.reduce == "min" else out.hi <= 0
        side = ">=" if program.reduce == "min" else "<="
        return PropertyFact(
            ok, "static",
            f"clamp apply; gather offset in [{out.lo:g}, {out.hi:g}] "
            f"({'is' if ok else 'is not'} {side} 0 as '{program.reduce}' "
            "needs)")
    return PropertyFact(False, "static",
                        "gather message is not source-value plus a "
                        "sign-bounded offset")


def _overflow_diags(program, gather_gm, diags) -> None:
    """A003: does ``gather(init)`` wrap the integer value dtype?"""
    dtype = program.value_dtype
    if _int_dtype(dtype) is None:
        return
    init = program.init_value
    if isinstance(init, str) or callable(init) \
            or not (np.isscalar(init) or np.ndim(init) == 0):
        return
    info = torch.iinfo(dtype)
    i = int(init)
    if i < info.min or i > info.max:
        diags.append(Diagnostic(
            "A003", "error", "init",
            f"init value {i} does not fit the value dtype {dtype} "
            f"(range [{info.min}, {info.max}]) — it wraps before the "
            "first superstep",
            f"use an init below {info.max} or widen value_dtype"))
        return
    if gather_gm is None:
        return
    state = _EvalState()
    # nominal weight magnitudes (the probes' uniform(1, 8) batch)
    _eval_graph(gather_gm, [torch.full((_N,), i, dtype=dtype),
                            _Rng(0.0, 8.0), _Rng(1.0, float(2**31 - 1))],
                state)
    if state.wrapped:
        diags.append(Diagnostic(
            "A003", "error", "gather",
            f"gather evaluated at the init value {i} overflows {dtype} — "
            "messages from unvisited sources silently wrap at runtime",
            "lower the init (e.g. bfs_program's default 2**30) or widen "
            "value_dtype"))


def _lattice_diags(program: VertexProgram, facts: dict, diags: list) -> None:
    """A004 (absorbing init) and A007 (no termination evidence)."""
    init = program.init_value
    ident = reduce_identity(program.reduce, program.value_dtype)
    init_is_ident = False
    if not isinstance(init, str) and not callable(init) \
            and (np.isscalar(init) or np.ndim(init) == 0):
        init_is_ident = bool(torch.tensor(init).to(ident.dtype) == ident)
    if init_is_ident and facts["identity_absorbing"].value \
            and facts["identity_fixpoint"].value:
        diags.append(Diagnostic(
            "A004", "warning", "init",
            f"init value equals the '{program.reduce}' reduce identity "
            f"({ident.item()}) everywhere, the gather absorbs it and the "
            "apply fixes it: no superstep changes any vertex until a "
            "source is seeded",
            "seed at least one vertex away from the identity (the "
            "algorithm layer's root injection) before running"))
    if program.frontier == "changed" and program.max_iters is None \
            and not facts["monotone"].value:
        diags.append(Diagnostic(
            "A007", "info", "program",
            "frontier='changed' with no max_iters and no "
            "monotone-convergence evidence — only the superstep budget "
            "bounds the run",
            "set max_iters, or use a min/max clamp apply the analyzer "
            "can prove monotone"))


# ---------------------------------------------------------------------------
# analyze_program (cached)
# ---------------------------------------------------------------------------

_ANALYSIS_CACHE: OrderedDict = OrderedDict()
_ANALYSIS_CACHE_MAX = 64


def analysis_cache_clear() -> None:
    """Drop all memoized :class:`ProgramAnalysis` results."""
    _ANALYSIS_CACHE.clear()


def analyze_program(program: VertexProgram) -> ProgramAnalysis:
    """Analyze a vertex program's gather and apply from their traced graphs
    (cached per program object).

    Traces both callables on fake ``(8,)`` tensors and decides every
    property the pass pipeline needs (see :class:`ProgramAnalysis`); a
    callable that cannot be traced falls back to the sampling probes with
    provenance ``'probed'`` and an ``A001`` diagnostic.  The DSL's
    template factories are memoized, so the natural
    ``translate(dsl.bfs_program(), ...)`` repeat hits this cache.
    """
    try:
        hash(program)                    # unhashable programs skip the cache
        key = program
    except TypeError:
        key = None
    if key is not None and key in _ANALYSIS_CACHE:
        _ANALYSIS_CACHE.move_to_end(key)
        return _ANALYSIS_CACHE[key]

    dtype = program.value_dtype
    gather_gm = _trace(program.gather, *_gather_examples(dtype))
    apply_gm = _trace(program.apply, *_apply_examples(dtype))
    diags: list = []

    facts = {
        "gather_module": _decide_module(program, gather_gm, diags),
        "weight_use": _decide_weight_use(program, gather_gm),
        "elementwise": _decide_elementwise(program, apply_gm, diags),
        "identity_fixpoint": _decide_fixpoint(program, apply_gm, diags),
        "identity_absorbing": _decide_absorbing(program, gather_gm, diags),
    }
    facts["monotone"] = _decide_monotone(program, gather_gm, apply_gm)
    _overflow_diags(program, gather_gm, diags)
    _lattice_diags(program, facts, diags)

    result = ProgramAnalysis(diagnostics=tuple(diags), **facts)
    if key is not None:
        _ANALYSIS_CACHE[key] = result
        while len(_ANALYSIS_CACHE) > _ANALYSIS_CACHE_MAX:
            _ANALYSIS_CACHE.popitem(last=False)
    return result


# ---------------------------------------------------------------------------
# IR verifier (structural invariants between passes)
# ---------------------------------------------------------------------------

# Canonical superstep order: ranks must be non-decreasing along ``ir.ops``.
_OP_RANK = {
    "GatherOp": 0,
    "FusedGatherReduceOp": 1,
    "FusedSuperstepOp": 1,
    "ReduceOp": 2,
    "PushScatterOp": 3,
    "ExchangeOp": 4,
    "ApplyOp": 5,
    "FrontierUpdateOp": 6,
}

_EXCHANGE_COLLECTIVES = {"add": "psum", "min": "pmin", "max": "pmax"}
_BACKENDS = ("dense_cuda", "dense_torch", "sparse_torch")


def _v(code, op, message, suggestion=""):
    return Diagnostic(code, "error", op, message, suggestion)


def verify_ir(ir, ctx=None) -> list:
    """Check :class:`~repro_torch.core.ir.SuperstepIR` structural invariants.

    Returns a list of error-severity ``V*`` diagnostics, empty for a
    well-formed IR; ``ctx`` enables the plan-agreement check (V007).
    """
    from .ir import (ExchangeOp, FrontierUpdateOp, FusedGatherReduceOp,
                     FusedSuperstepOp, GatherOp, PushScatterOp, ReduceOp)

    program = ir.program
    out = []
    counts: dict = {}
    for op in ir.ops:
        counts[type(op).__name__] = counts.get(type(op).__name__, 0) + 1

    # V001 — op multiplicity
    for name, n in counts.items():
        if n > 1:
            out.append(_v("V001", name, f"{n} {name} ops in one superstep "
                          "(each stage appears at most once)"))
    gather_planes = sum(counts.get(n, 0) for n in
                        ("GatherOp", "FusedGatherReduceOp",
                         "FusedSuperstepOp"))
    if gather_planes != 1:
        out.append(_v("V001", "Gather",
                      f"{gather_planes} gather-plane ops (exactly one of "
                      "Gather/FusedGatherReduce/FusedSuperstep required)"))
    fused_any = counts.get("FusedGatherReduceOp", 0) \
        + counts.get("FusedSuperstepOp", 0)
    if bool(counts.get("ReduceOp", 0)) == bool(fused_any):
        out.append(_v("V001", "Reduce",
                      "ReduceOp must be present exactly when no fused "
                      "gather+reduce op is"))
    step = ir.find(FusedSuperstepOp)
    for name in ("ApplyOp", "FrontierUpdateOp"):
        if bool(counts.get(name, 0)) == (step is not None):
            out.append(_v("V001", name,
                          f"{name} must be present exactly when the "
                          "superstep is not fused into one stage"))

    # V002 — op ordering
    ranks = [_OP_RANK.get(type(op).__name__) for op in ir.ops]
    if None in ranks:
        bad = type(ir.ops[ranks.index(None)]).__name__
        out.append(_v("V002", bad, f"unknown op class {bad} in the IR"))
    elif any(a > b for a, b in zip(ranks, ranks[1:])):
        out.append(_v("V002", "ops",
                      "ops out of canonical superstep order "
                      "(gather → reduce → push → exchange → apply → "
                      "frontier): "
                      + " -> ".join(type(o).__name__ for o in ir.ops)))

    gop = ir.find(GatherOp)
    fgr = ir.find(FusedGatherReduceOp)
    if step is not None:
        fgr = step.fused
    if gop is None and fgr is not None:
        gop = fgr.gather
    rop = ir.find(ReduceOp)
    if rop is None and fgr is not None:
        rop = fgr.reduce

    # V003 — reduce consistency
    if rop is not None:
        if rop.op != program.reduce:
            out.append(_v("V003", "Reduce",
                          f"reduce op {rop.op!r} disagrees with the "
                          f"program's {program.reduce!r}"))
        if rop.identity is not None:
            want = reduce_identity(rop.op, ir.value_dtype)
            got = torch.as_tensor(rop.identity)
            if got.dtype != ir.value_dtype or not _equal(got, want):
                out.append(_v(
                    "V003", "Reduce",
                    f"folded identity {rop.identity!r} is not "
                    f"reduce_identity({rop.op!r}, {ir.value_dtype})"))

    # V004 — gather module annotation
    if gop is not None and gop.module is not None \
            and gop.module not in GATHER_OPS:
        out.append(_v("V004", "Gather",
                      f"annotated module {gop.module!r} names no menu "
                      f"module (menu: {', '.join(GATHER_OPS)})"))

    # V005 — direction legality preconditions
    push = ir.find(PushScatterOp)
    direction = gop.direction if gop is not None else "pull"
    if fgr is not None:
        direction = fgr.direction
    if direction == "both" or push is not None:
        reasons = []
        if program.reduce not in _COMMUTATIVE_REDUCES:
            reasons.append(f"reduce {program.reduce!r} is not commutative")
        if program.reduce == "add" and ir.value_dtype.is_floating_point:
            reasons.append("float add is order-sensitive")
        if not program.mask_inactive:
            reasons.append("mask_inactive=False")
        if program.frontier != "changed":
            reasons.append(f"frontier={program.frontier!r}")
        if reasons:
            out.append(_v("V005", "PushScatter" if push else "Gather",
                          "push direction bound without its preconditions: "
                          + "; ".join(reasons)))

    # V006 — backend/kernel agreement
    if ir.backend is not None:
        if ir.backend not in _BACKENDS:
            out.append(_v("V006", "backend",
                          f"unknown backend {ir.backend!r}"))
        if fgr is not None:
            want = "edge_block" if ir.backend.startswith("dense") \
                else "segment_scan"
            if fgr.kernel != want:
                out.append(_v("V006", "FusedGatherReduce",
                              f"kernel {fgr.kernel!r} disagrees with "
                              f"backend {ir.backend!r} (expected {want!r})"))
        if push is not None and push.layout == "fwd_ell" \
                and not ir.backend.startswith("dense"):
            out.append(_v("V006", "PushScatter",
                          "fwd_ell push layout needs a dense backend "
                          f"(backend is {ir.backend!r})"))
    elif fgr is not None:
        out.append(_v("V006", "FusedGatherReduce",
                      "gather+reduce fused before a backend was resolved"))

    # V007 — exchange-plane consistency
    xop = ir.find(ExchangeOp)
    if xop is not None:
        if xop.reduce != program.reduce:
            out.append(_v("V007", "Exchange",
                          f"exchange reduce {xop.reduce!r} disagrees with "
                          f"the program's {program.reduce!r}"))
        if xop.collective is not None:
            want = _EXCHANGE_COLLECTIVES.get(xop.reduce)
            if xop.collective != want:
                out.append(_v("V007", "Exchange",
                              f"collective {xop.collective!r} is not the "
                              f"reduce-matched {want!r}"))
            if xop.pes is None or xop.pes <= 1:
                out.append(_v("V007", "Exchange",
                              "resolved collective with pes <= 1 (a "
                              "single-PE exchange should be elided)"))
            if ctx is not None and xop.pes is not None \
                    and xop.pes != ctx.plan.pes:
                out.append(_v("V007", "Exchange",
                              f"exchange pes={xop.pes} disagrees with the "
                              f"schedule plan's pes={ctx.plan.pes}"))

    # V008 — frontier consistency
    fop = ir.find(FrontierUpdateOp)
    if fop is None and step is not None:
        fop = step.frontier
    if fop is not None:
        if fop.mode != program.frontier:
            out.append(_v("V008", "FrontierUpdate",
                          f"frontier mode {fop.mode!r} disagrees with the "
                          f"program's {program.frontier!r}"))
        if fop.dead and fop.mode != "all":
            out.append(_v("V008", "FrontierUpdate",
                          "frontier marked dead but mode is "
                          f"{fop.mode!r} (only 'all' frontiers are dead)"))

    # V009 — fused-superstep binding preconditions
    if step is not None:
        if step.pull_sweep == "bitmap":
            reasons = []
            if not program.mask_inactive:
                reasons.append("mask_inactive=False")
            if program.frontier != "changed":
                reasons.append(f"frontier={program.frontier!r}")
            if not (ir.backend or "").startswith("dense"):
                reasons.append(f"backend {ir.backend!r} is not dense")
            if reasons:
                out.append(_v("V009", "FusedSuperstep",
                              "bitmap pull sweep bound without its "
                              "preconditions: " + "; ".join(reasons)))
        if step.touched_free and program.frontier != "changed":
            out.append(_v("V009", "FusedSuperstep",
                          "touched-mask elision bound with "
                          f"frontier={program.frontier!r} (needs "
                          "'changed')"))
    return out

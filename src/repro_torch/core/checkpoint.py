"""Durable checkpoint/restore: versioned, CRC-checksummed run snapshots.

Counterpart of ``repro.core.checkpoint``, writing and reading the same
container, so a snapshot taken by either package restores in the other.
A snapshot captures the complete resumable state of a run (the 15-field
lane carry of :class:`~repro_torch.core.translator.BatchLaneState` for
resident runs, the request WAL plus lane states for the serving plane)
together with *fingerprints* of everything the state is only meaningful
against: the graph's structure bytes, the program's code, the schedule.
Restoring against mismatched inputs raises a typed
:class:`~repro_torch.errors.CheckpointMismatchError` instead of resuming
into silently wrong numerics.

Snapshot format (version ``SNAPSHOT_VERSION``)::

    <dir>/<kind>-<seq:08d>.npz     arrays (uncompressed npz)
    <dir>/<kind>-<seq:08d>.json    manifest — the commit record

The manifest carries the format version, kind, per-array CRC32s (over
dtype + shape + bytes), the fingerprints, and a free-form ``meta`` dict.
Writes are atomic: both files are written to temp names and
``os.replace``-d into place, **manifest last**: the manifest's appearance
is the commit point, so a crash mid-write leaves either the previous
snapshot intact or a complete new one (the ``checkpoint.write`` fault
point sits right before the renames).  Reads verify every CRC and raise
:class:`~repro_torch.errors.CheckpointCorruptError` on truncated or
bit-flipped files.

Fingerprints are strings:

* **graph** — CRC32 over the CSR arrays (offsets, destinations, weights)
  plus ``(V, E)``: the same value the JAX package computes for the same
  graph (int32 offsets and ids, float32 weights, little-endian bytes).
* **program** — the :class:`~repro_torch.core.dsl.VertexProgram`'s name
  plus a CRC over each callable's bytecode, constants and closure cells
  (``ppr_program(root=3)`` and ``root=4`` differ by their closure values).
  A tensor in a cell is CRC'd by its dtype, shape and bytes, a torch
  builtin or dtype by its qualified name; memory addresses never enter
  the hash, so fingerprints are stable across process restarts.
  Programs are package-specific code, so the two packages' program
  fingerprints differ for the "same" template.
* **schedule** — the CRC of the JAX package's ``ScheduleConfig`` repr
  for the same settings (the fields this package does not have yet take
  the JAX package's defaults), so both packages agree.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import types
import zlib

import numpy as np
import torch

from ..errors import (CheckpointCorruptError, CheckpointError,
                      CheckpointMismatchError)
from . import faults

__all__ = [
    "SNAPSHOT_VERSION",
    "DEFAULT_STREAM_SWEEPS",
    "DEFAULT_LANE_SUPERSTEPS",
    "KEEP_SNAPSHOTS",
    "array_crc32",
    "fingerprint_graph",
    "fingerprint_program",
    "fingerprint_schedule",
    "run_fingerprints",
    "check_fingerprints",
    "write_snapshot",
    "read_snapshot",
    "list_snapshots",
    "latest_snapshot",
    "prune_snapshots",
    "require_snapshot",
]

SNAPSHOT_VERSION = 1
FORMAT_NAME = "repro-checkpoint"

# default checkpoint cadences, the JAX package's: the streamed engine
# snapshots after every N partition sweeps, the resident engine after
# every K supersteps of its budgeted slice loop
DEFAULT_STREAM_SWEEPS = 8
DEFAULT_LANE_SUPERSTEPS = 4

# how many committed snapshots a writer keeps per kind: the newest is
# the resume point, one predecessor survives as insurance against a
# crash *during* the newest write being armed (the rename is atomic, but
# keeping N-1 costs one small file and removes the single point)
KEEP_SNAPSHOTS = 2


# ---------------------------------------------------------------------------
# CRCs and fingerprints
# ---------------------------------------------------------------------------


def _host(arr) -> np.ndarray:
    """A contiguous host numpy array of ``arr`` (a tensor on any device,
    a numpy array, or anything ``np.asarray`` takes)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(arr))


def array_crc32(arr) -> int:
    """CRC32 over an array's dtype, shape, and contiguous bytes."""
    a = _host(arr)
    crc = zlib.crc32(str(a.dtype).encode())
    crc = zlib.crc32(repr(tuple(a.shape)).encode(), crc)
    return zlib.crc32(a.tobytes(), crc) & 0xFFFFFFFF


def fingerprint_graph(source) -> str:
    """Fingerprint a resident graph or a partition container.

    A container (anything with ``partition_coo``) is fingerprinted from
    its cut geometry and build-time per-partition CRCs, as the JAX package
    does, so the two packages agree; a resident graph hashes its CSR
    structure arrays.  Vertex *values* never enter the fingerprint: they
    are run state, not graph identity.
    """
    if hasattr(source, "partition_coo"):
        crc = zlib.crc32(np.ascontiguousarray(
            np.asarray(source.cuts, np.int64)).tobytes())
        crc = zlib.crc32(np.ascontiguousarray(
            np.asarray(source.edges_per_partition, np.int64)).tobytes(), crc)
        checksums = getattr(source, "checksums", None)
        if checksums is not None:
            crc = zlib.crc32(np.ascontiguousarray(
                np.asarray(checksums, np.int64)).tobytes(), crc)
        return (f"container:V{int(source.num_vertices)}"
                f":E{int(source.num_edges)}:P{int(source.partitions)}"
                f":{crc & 0xFFFFFFFF:08x}")
    off = _host(source.edge_offsets)
    dst = _host(source.edges_dst)
    crc = zlib.crc32(off.tobytes())
    crc = zlib.crc32(dst.tobytes(), crc)
    wgt = getattr(source, "edge_weights", None)
    if wgt is not None:
        crc = zlib.crc32(_host(wgt).tobytes(), crc)
    return (f"graph:V{int(source.num_vertices)}:E{int(source.num_edges)}"
            f":{crc & 0xFFFFFFFF:08x}")


def _code_crc(code: types.CodeType, crc: int) -> int:
    """CRC a code object without ever hashing a repr containing addresses."""
    crc = zlib.crc32(code.co_code, crc)
    crc = zlib.crc32(repr(code.co_names).encode(), crc)
    crc = zlib.crc32(repr(code.co_varnames).encode(), crc)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            crc = _code_crc(const, crc)
        else:
            crc = zlib.crc32(repr(const).encode(), crc)
    return crc


def _value_crc(v, crc: int) -> int:
    """CRC one closure cell's or field's non-callable value, address-free:
    arrays and tensors by dtype, shape and bytes, a torch dtype or device
    by its name, anything else by its repr."""
    if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
        return zlib.crc32(np.int64(array_crc32(v)).tobytes(), crc)
    if isinstance(v, (torch.dtype, torch.device)):
        return zlib.crc32(str(v).encode(), crc)
    return zlib.crc32(repr(v).encode(), crc)


def _callable_crc(fn, crc: int = 0) -> int:
    """CRC a callable: bytecode + constants + closure cell values.

    ``functools.partial`` hashes its func plus bound args; closures hash
    their cell contents (the parameter a memoized template baked in —
    ``ppr_program(3)`` vs ``ppr_program(4)`` differ exactly here).
    Builtins, torch functions and other code-less callables hash their
    qualified name, which is address-free and import-stable.
    """
    if isinstance(fn, functools.partial):
        crc = _callable_crc(fn.func, crc)
        for arg in fn.args:
            crc = _value_crc(arg, crc)
        for key, arg in sorted(fn.keywords.items()):
            crc = zlib.crc32(key.encode(), crc)
            crc = _value_crc(arg, crc)
        return crc
    code = getattr(fn, "__code__", None)
    if code is None:
        name = (getattr(fn, "__module__", "") or "") + "." \
            + (getattr(fn, "__qualname__", None)
               or getattr(fn, "__name__", None) or type(fn).__qualname__)
        return zlib.crc32(name.encode(), crc)
    crc = _code_crc(code, crc)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:
            crc = zlib.crc32(b"<empty-cell>", crc)
            continue
        if callable(v) and not isinstance(v, (type, torch.Tensor)):
            crc = _callable_crc(v, crc)
        else:
            crc = _value_crc(v, crc)
    return crc


def fingerprint_program(program) -> str:
    """Fingerprint a :class:`~repro_torch.core.dsl.VertexProgram` by
    content."""
    crc = 0
    for f in dataclasses.fields(program):
        v = getattr(program, f.name)
        crc = zlib.crc32(f.name.encode(), crc)
        if callable(v) and not isinstance(v, (type, torch.Tensor)):
            crc = _callable_crc(v, crc)
        else:
            crc = _value_crc(v, crc)
    return f"program:{program.name}:{crc & 0xFFFFFFFF:08x}"


# The JAX package's ScheduleConfig fields, in its order; a field this
# package's ScheduleConfig lacks renders with the JAX package's default.
_SCHEDULE_FIELDS = (
    ("pipelines", 8), ("pes", 1), ("backend", "auto"), ("block_rows", 128),
    ("message_dtype", None), ("direction", None), ("push_ell_width", 8),
    ("pull_sweep", "auto"), ("pull_block_slots", 64), ("partitions", 1),
    ("partition_budget_bytes", None), ("max_supersteps", None),
    ("probe_divergence", False))


def _schedule_repr(schedule) -> str:
    """The repr the JAX package's ``ScheduleConfig`` has for the same
    settings (what :func:`fingerprint_schedule` hashes)."""
    own = {f.name for f in dataclasses.fields(schedule)}
    extra = own - {name for name, _ in _SCHEDULE_FIELDS}
    if extra:
        raise ValueError(f"schedule fields unknown to the snapshot format: "
                         f"{sorted(extra)}")
    parts = [f"{name}={getattr(schedule, name, default)!r}"
             for name, default in _SCHEDULE_FIELDS]
    return f"ScheduleConfig({', '.join(parts)})"


def fingerprint_schedule(schedule) -> str:
    """Fingerprint a frozen :class:`ScheduleConfig` (deterministic repr)."""
    crc = zlib.crc32(_schedule_repr(schedule).encode()) & 0xFFFFFFFF
    return f"schedule:{crc:08x}"


def run_fingerprints(program, source, schedule) -> dict:
    """The three fingerprints every run snapshot carries."""
    return {"graph": fingerprint_graph(source),
            "program": fingerprint_program(program),
            "schedule": fingerprint_schedule(schedule)}


def check_fingerprints(manifest: dict, expect: dict, *, path: str = "") -> None:
    """Raise :class:`CheckpointMismatchError` on the first mismatch."""
    got = manifest.get("fingerprints", {})
    for field in ("graph", "program", "schedule"):
        if field not in expect:
            continue
        if got.get(field) != expect[field]:
            raise CheckpointMismatchError(
                f"snapshot {path or manifest.get('kind', '?')} was taken "
                f"against a different {field}: snapshot has "
                f"{got.get(field)!r}, this run has {expect[field]!r}",
                field=field, expected=expect[field],
                got=str(got.get(field)))


# ---------------------------------------------------------------------------
# Snapshot read/write
# ---------------------------------------------------------------------------


def _stem(directory: str, kind: str, seq: int) -> str:
    return os.path.join(directory, f"{kind}-{int(seq):08d}")


def _jsonable(obj):
    """Convert numpy scalars/arrays nested in meta dicts to JSON types."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def write_snapshot(directory: str, kind: str, seq: int,
                   arrays: dict, meta: dict,
                   fingerprints: dict, *, keep: int = KEEP_SNAPSHOTS) -> str:
    """Atomically commit one snapshot; returns the path stem.

    Arrays land in ``<stem>.npz``, everything else in the ``<stem>.json``
    manifest.  Both are written to temp names and renamed into place,
    manifest last: the manifest is the commit record, so readers either
    see a complete snapshot or none.  The ``checkpoint.write`` fault
    point trips *before* the renames — an injected crash there leaves
    only temp litter, which :func:`latest_snapshot` never considers.
    Older snapshots beyond ``keep`` are pruned after the commit.
    """
    os.makedirs(directory, exist_ok=True)
    stem = _stem(directory, kind, seq)
    arrays = {k: _host(v) for k, v in arrays.items()}
    manifest = {
        "format": FORMAT_NAME,
        "version": SNAPSHOT_VERSION,
        "kind": kind,
        "seq": int(seq),
        "arrays_file": os.path.basename(stem) + ".npz",
        "arrays": {k: {"crc32": array_crc32(a), "dtype": str(a.dtype),
                       "shape": list(a.shape)} for k, a in arrays.items()},
        "fingerprints": dict(fingerprints),
        "meta": _jsonable(meta),
    }
    tmp_npz = stem + f".npz.tmp.{os.getpid()}"
    tmp_json = stem + f".json.tmp.{os.getpid()}"
    try:
        with open(tmp_npz, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(tmp_json, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        faults.trip("checkpoint.write",
                    payload={"kind": kind, "seq": int(seq)})
        os.replace(tmp_npz, stem + ".npz")
        os.replace(tmp_json, stem + ".json")
    finally:
        for tmp in (tmp_npz, tmp_json):
            if os.path.exists(tmp):
                os.unlink(tmp)
    prune_snapshots(directory, kind, keep=keep)
    return stem


def read_snapshot(stem: str, *, kind: str | None = None,
                  expect: dict | None = None) -> tuple[dict, dict]:
    """Load + verify one snapshot; returns ``(manifest, arrays)``.

    Every integrity failure is typed: an unreadable/truncated manifest or
    npz, a missing array member, or a CRC mismatch raises
    :class:`CheckpointCorruptError`; a format/kind/fingerprint
    disagreement raises :class:`CheckpointMismatchError`.  ``expect``
    maps fingerprint fields to the restoring run's values (see
    :func:`check_fingerprints`).
    """
    mpath = stem + ".json"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable snapshot manifest {mpath}: {e}", path=mpath) from e
    if manifest.get("format") != FORMAT_NAME \
            or manifest.get("version") != SNAPSHOT_VERSION:
        raise CheckpointMismatchError(
            f"{mpath} is not a version-{SNAPSHOT_VERSION} "
            f"{FORMAT_NAME} manifest (format={manifest.get('format')!r}, "
            f"version={manifest.get('version')!r})",
            field="version", expected=str(SNAPSHOT_VERSION),
            got=str(manifest.get("version")))
    if kind is not None and manifest.get("kind") != kind:
        raise CheckpointMismatchError(
            f"{mpath} holds a {manifest.get('kind')!r} snapshot, "
            f"expected {kind!r}", field="kind", expected=kind,
            got=str(manifest.get("kind")))
    if expect:
        check_fingerprints(manifest, expect, path=mpath)
    apath = os.path.join(os.path.dirname(stem) or ".",
                         manifest["arrays_file"])
    try:
        with np.load(apath) as z:
            arrays = {k: np.array(z[k]) for k in z.files}
    except Exception as e:
        raise CheckpointCorruptError(
            f"unreadable snapshot arrays {apath}: {e}", path=apath) from e
    for name, rec in manifest.get("arrays", {}).items():
        if name not in arrays:
            raise CheckpointCorruptError(
                f"snapshot {apath} is missing array {name!r} recorded in "
                f"its manifest", path=apath, member=name)
        crc = array_crc32(arrays[name])
        if crc != int(rec["crc32"]):
            raise CheckpointCorruptError(
                f"snapshot array {name!r} failed its CRC32 in {apath}: "
                f"computed {crc:#010x}, manifest records "
                f"{int(rec['crc32']):#010x}", path=apath, member=name)
    return manifest, arrays


def list_snapshots(directory: str, kind: str) -> list[tuple[int, str]]:
    """Committed ``(seq, stem)`` pairs for ``kind``, ascending by seq.

    Only manifests count — an orphan ``.npz`` from an interrupted write
    is invisible here, which is what makes the manifest the commit point.
    """
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    prefix = kind + "-"
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".json")):
            continue
        seq_part = name[len(prefix):-len(".json")]
        if not seq_part.isdigit():
            continue
        out.append((int(seq_part), os.path.join(directory, name)[:-5]))
    out.sort()
    return out


def latest_snapshot(directory: str, kind: str) -> str | None:
    """Stem of the newest committed snapshot of ``kind``, or None."""
    snaps = list_snapshots(directory, kind)
    return snaps[-1][1] if snaps else None


def prune_snapshots(directory: str, kind: str,
                    *, keep: int = KEEP_SNAPSHOTS) -> None:
    """Drop all but the newest ``keep`` committed snapshots of ``kind``."""
    snaps = list_snapshots(directory, kind)
    for _, stem in snaps[:max(0, len(snaps) - keep)]:
        for suffix in (".json", ".npz"):   # manifest first: uncommit, then
            try:                           # drop the arrays it referenced
                os.unlink(stem + suffix)
            except OSError:
                pass


def require_snapshot(directory: str, kind: str) -> str:
    """Like :func:`latest_snapshot` but raises when nothing is committed."""
    stem = latest_snapshot(directory, kind)
    if stem is None:
        raise CheckpointError(
            f"no committed {kind!r} snapshot in {directory!r} to resume "
            f"from")
    return stem

"""Fault-tolerant training checkpoints: save/restore with a manifest and
checksums, atomic rename, async background writes, auto-resume.

Counterpart of ``repro.train.checkpoint``, in its format byte for byte:
one ``.npy`` per tree leaf under ``step_<n>.tmp/`` (leaf names are the
``/``-joined dict keys and tuple indices, files ``a__b.npy``), renamed to
``step_<n>/`` only after ``manifest.json`` (``step``; each leaf's
``file``, ``shape``, ``dtype`` and the CRC32 of its bytes) and the
directory are durably written, so a torn write never looks like a valid
checkpoint.  A bfloat16 leaf is written as the JAX package writes an
``ml_dtypes.bfloat16`` array (header descr ``'<V2'``, manifest dtype
``"bfloat16"``) and read back as ``torch.bfloat16``; neither step needs
``ml_dtypes``.  The JAX ``restore`` cannot read such a leaf back (it
hands a ``|V2`` array to ``jnp.asarray``); this one can.  Trees are
nested dicts and tuples of tensors (``{"params": model.param_tree(),
"opt": opt_state}``); ``restore`` places every leaf on one ``device``,
or reshards it: a leaf given a ``sharding.partition.NamedSharding`` in
``shardings=`` comes back as its shards on that sharding's mesh (which
may differ from the mesh that wrote the checkpoint: elastic restart),
and ``partition.unshard`` joins them again.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from ..models.param import leaves

_BF16 = "bfloat16"


def _flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in leaves(tree)]


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf's bytes on the host and its manifest dtype (a bfloat16
    tensor as 2-byte raw words), copied."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2"), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:     # np.save of ml_dtypes' bfloat16
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree: Any, *, asynchronous: bool = False
         ) -> threading.Thread | None:
    """Write the checkpoint of ``step``; the leaves are copied to the host
    first, so the caller may go on updating its tensors.  Returns the
    writer thread if ``asynchronous``."""
    host = [(name,) + _host(leaf) for name, leaf in _flatten_with_paths(tree)]

    def _write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for name, arr, dtype in host:
            fn = name.replace("/", "__") + ".npy"
            _write_leaf(os.path.join(tmp, fn), arr, dtype)
            manifest["leaves"][name] = {
                "file": fn,
                "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": zlib.crc32(arr.tobytes()),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)

    if asynchronous:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> int | None:
    """Newest *valid* checkpoint (must have a readable manifest)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")        # a copy; a 0-d leaf stays 0-d
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _rebuild(like: Any, out: dict, prefix: tuple = ()) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, out, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, tuple):
        return tuple(_rebuild(v, out, prefix + (i,))
                     for i, v in enumerate(like))
    return out["/".join(str(k) for k in prefix)]


def restore(ckpt_dir: str, step: int, like: Any, *, shardings: Any = None,
            device=None, verify: bool = True) -> Any:
    """Restore into the structure of ``like`` (its leaves give only the
    shapes), every leaf a tensor of the dtype written, on ``device`` (the
    CPU when None).  ``shardings``: a tree like ``like``'s (or part of
    it) of ``NamedSharding``s; each leaf it names comes back as the list
    of its shards in its mesh's device order, each on its device.
    ``verify`` checks each leaf's CRC32."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shard_named = dict(_flatten_with_paths(shardings)) if shardings else {}
    out = {}
    for name, ref in _flatten_with_paths(like):
        ent = manifest["leaves"][name]
        arr = np.load(os.path.join(path, ent["file"]))
        if verify and zlib.crc32(arr.tobytes()) != ent["crc32"]:
            raise IOError(f"checksum mismatch for leaf {name}")
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} "
                             f"vs {tuple(np.shape(ref))}")
        if name in shard_named:
            out[name] = shard_named[name].split(
                _to_tensor(arr, ent["dtype"], "cpu"))
        else:
            out[name] = _to_tensor(arr, ent["dtype"], device)
    return _rebuild(like, out)


def restore_latest(ckpt_dir: str, like: Any, **kw) -> tuple[Any, int] | None:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore(ckpt_dir, step, like, **kw), step


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)

"""Communication manager (paper §V-C1): placement, transfer accounting,
and the cross-PE exchange of a PE group.

Counterpart of ``repro.core.comm``.  The JAX package runs its PEs as a
``pe`` mesh axis inside one process and combines per-PE partial tables
with ``jax.lax`` collectives inside ``shard_map``.  This package is a
single controller too: a PE group is a list of devices (a device may
repeat, which is how several PEs share one card or the CPU), each PE's
partial table lives on its PE's device, and the collectives here are
functions over the list of per-PE tensors that return the combined table
once, on the group's home device (the device the run's state lives on).
Each PE's partial moves there with a ``non_blocking`` copy (none when it
is already there).  The collectives:

* :func:`psum` / :func:`pmin` / :func:`pmax` — the reduce-matched
  full-precision combines (``COLLECTIVES``), folded in PE order; a float
  min/max settles a +0/-0 tie as the CUDA kernels do (-0 < +0);
* :func:`quantized_psum` — the int8 wire format of a float-add exchange,
  step for step the JAX function (shared scale, int8 chunks summed
  exactly in int32, an adaptive second scale, int8 all-gather);
* :func:`bitmap_or` — the OR fold, in PE order, of packed frontier words.

The byte estimates (:meth:`CommManager.estimate_collective_bytes`,
:meth:`CommManager.estimate_frontier_bytes`) are the JAX package's
formulas for a ring all-reduce and a bitmap all-gather, and the run loop
records the exchanges that ran (:meth:`TransferStats.record_collective`,
the ``comm.collective`` fault point).

Entry points take ``device=None`` to mean the CUDA device, and raise when
there is none: the port never falls back to the CPU unless asked to.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.ref import combine_settled
from . import faults
from .graph import to_device


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; raises when CUDA is absent.

    An explicit ``device="cpu"`` (what the CPU tests pass) is honoured.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


@dataclasses.dataclass
class TransferStats:
    """Placement bytes, the cross-PE exchange plane, and the streamed
    engine's partition plane.

    ``collective_bytes_per_superstep`` and ``frontier_bytes_per_superstep``
    are the estimates of one combine (set by the ``estimate_*`` methods,
    never summed); ``collective_supersteps`` / ``collective_bytes_total``
    accumulate the exchanges the host loop executed
    (:meth:`record_collective`): the supersteps that ran an exchange (a
    batched superstep counts once) and the bytes of the ``(V,)`` tables
    they exchanged (one a sequential superstep, one a lane of a batched
    push).

    The partition fields, as in the JAX package: bytes the partition
    stream shipped host→device, the partition sweeps it covered and those
    the frontier skipped before any transfer, and the transfer / compute
    / wall triple that overlap is measured from (perfect overlap: wall ≈
    max(transfer, compute); none: wall ≈ transfer + compute).  On CUDA the
    transfer and compute seconds are CUDA-event times of the copies on the
    copy stream and of the sweeps on the compute stream; the wall is the
    host clock.  Retries and corruptions count the fetch failures the
    stream absorbed.
    """

    host_to_device_bytes: int = 0
    device_to_host_bytes: int = 0
    collective_bytes_per_superstep: int = 0
    frontier_bytes_per_superstep: int = 0
    collective_supersteps: int = 0
    collective_bytes_total: int = 0
    placements: int = 0
    partition_bytes_h2d: int = 0
    partitions_transferred: int = 0
    partitions_skipped: int = 0
    partition_prefetch_s: float = 0.0
    partition_compute_s: float = 0.0
    partition_wall_s: float = 0.0
    partition_retries: int = 0
    partition_corruptions: int = 0

    def record_h2d(self, nbytes: int):
        self.host_to_device_bytes += int(nbytes)
        self.placements += 1

    def record_d2h(self, nbytes: int):
        self.device_to_host_bytes += int(nbytes)

    def record_partition_h2d(self, nbytes: int, seconds: float = 0.0):
        """One partition's arrays entered the stream."""
        self.partition_bytes_h2d += int(nbytes)
        self.partitions_transferred += 1
        self.partition_prefetch_s += float(seconds)

    def record_partition_skip(self, n: int = 1):
        """Partition sweeps the frontier summary killed before transfer."""
        self.partitions_skipped += int(n)

    def record_partition_superstep(self, wall_s: float, compute_s: float):
        """One streamed superstep's wall clock and compute time."""
        self.partition_wall_s += float(wall_s)
        self.partition_compute_s += float(compute_s)

    def overlap_efficiency(self) -> float:
        """Measured transfer/compute overlap of the partition stream, 0..1:
        ``(transfer + compute − wall) / min(transfer, compute)``, the share
        of the shorter phase that was hidden (0 when nothing streamed)."""
        shorter = min(self.partition_prefetch_s, self.partition_compute_s)
        if shorter <= 0.0 or self.partition_wall_s <= 0.0:
            return 0.0
        hidden = (self.partition_prefetch_s + self.partition_compute_s
                  - self.partition_wall_s)
        return float(np.clip(hidden / shorter, 0.0, 1.0))

    def record_partition_retry(self, n: int = 1):
        """A transient partition fetch failure was retried."""
        self.partition_retries += int(n)

    def record_partition_corruption(self, n: int = 1):
        """A checksum mismatch forced an evict and a re-read."""
        self.partition_corruptions += int(n)

    def record_collective(self, nbytes_per_superstep: int, supersteps: int,
                          tables: int | None = None):
        """Accumulate the executed exchanges of a run or a slice (run-loop
        wiring): ``supersteps`` that exchanged, ``tables`` ``(V,)`` tables
        in all (default: one a superstep) of ``nbytes_per_superstep``
        each.

        Also the ``comm.collective`` fault point: an armed point raises
        here, when a run records an exchange, so a poisoned collective
        surfaces as a typed error instead of a wrong answer.
        """
        faults.trip("comm.collective")
        self.collective_supersteps += int(supersteps)
        self.collective_bytes_total += (int(nbytes_per_superstep) * int(
            supersteps if tables is None else tables))


def _nbytes(tree: Any) -> int:
    """Bytes of every tensor in a tensor, dataclass, tuple or list."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(_nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _gathered(parts, device):
    """The per-PE tensors on the home device (the first PE's by default),
    in PE order."""
    if not parts:
        raise ValueError("a collective needs at least one PE's tensor")
    home = parts[0].device if device is None else torch.device(device)
    return home, [p.to(home, non_blocking=True) for p in parts]


def psum(parts, device=None) -> torch.Tensor:
    """Sum of the per-PE tables, added in PE order (an int32 sum wraps)."""
    _, parts = _gathered(parts, device)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _fold(parts, device, reduce: str) -> torch.Tensor:
    _, parts = _gathered(parts, device)
    out = parts[0]
    for p in parts[1:]:
        out = combine_settled(out, p, reduce)
    return out


def pmin(parts, device=None) -> torch.Tensor:
    """Elementwise min of the per-PE tables (NaN propagates; a float
    +0/-0 tie settles as -0 < +0)."""
    return _fold(parts, device, "min")


def pmax(parts, device=None) -> torch.Tensor:
    """Elementwise max of the per-PE tables (NaN propagates; a float
    +0/-0 tie settles as -0 < +0)."""
    return _fold(parts, device, "max")


# IR collective name (resolved by the backend-selection pass) → combine;
# shared by the pull-plane exchange and the sharded push
COLLECTIVES = {"psum": psum, "pmin": pmin, "pmax": pmax}
# reduce → its collective's name
REDUCE_COLLECTIVE = {"add": "psum", "min": "pmin", "max": "pmax"}


def quantize_messages(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of vertex messages: ``(q, scale)``."""
    scale = torch.clamp_min(x.abs().max(), 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_messages(q: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale


def quantized_psum(parts, device=None) -> torch.Tensor:
    """Sum of the per-PE ``(V,)`` float tables with an int8 wire format,
    the JAX package's ``CommManager.quantized_psum`` step for step:

    1. the shared scale ``max(max_p max|x_p|, 1e-8) / 127``;
    2. each PE quantizes its table on its device: ``round`` half to even,
       clipped to ±127, int8 (what crosses to the home device);
    3. the int8 tables padded to a multiple of ``pes`` and cut into
       ``(pes, V/pes)`` chunks, each chunk summed over the PEs exactly in
       int32;
    4. the second scale ``max(max|Σq|, 1) / 127`` and the chunk sums
       re-quantized onto it (int8, the all-gather's wire);
    5. ``q₂ · (scale₂ · scale)``.

    The same IEEE operations in the same order as the JAX function, so
    the result equals it bit for bit.  Error per element: at most
    ``pes · scale``.  Only float-add exchanges take it; min, max and
    integer add keep the exact collective.
    """
    if not parts:
        raise ValueError("a collective needs at least one PE's tensor")
    home = parts[0].device if device is None else torch.device(device)
    pes = len(parts)
    v = parts[0].shape[0]
    absmax = torch.stack([p.abs().max().to(home) for p in parts]).max()
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = []
    for p in parts:
        s = scale.to(p.device, non_blocking=True)
        q.append(torch.clamp(torch.round(p / s), -127, 127)
                 .to(torch.int8).to(home, non_blocking=True))
    pad = (-v) % pes
    chunk_sum = sum(torch.nn.functional.pad(x.to(torch.int32), (0, pad))
                    .reshape(pes, -1) for x in q)
    scale2 = (torch.clamp_min(chunk_sum.abs().max(), 1).to(torch.float32)
              / 127.0)
    q2 = torch.clamp(torch.round(chunk_sum / scale2), -127, 127).to(
        torch.int8)
    full = q2.reshape(-1)[:v]
    return full.to(parts[0].dtype) * (scale2 * scale)


def bitmap_or(parts, device=None) -> torch.Tensor:
    """OR of the per-PE packed frontier words (``graph.pack_bits``), folded
    in PE order: the touched-mask exchange of the sharded pull plane, bit
    for bit the int8 max of the unpacked masks."""
    _, parts = _gathered(parts, device)
    out = parts[0]
    for p in parts[1:]:
        out = out | p
    return out


class CommManager:
    """Paper: 'control shell' — a placement/transfer planner.

    ``devices`` names a PE group (the counterpart of the JAX package's
    ``mesh``); :meth:`status` reports it as a one-axis ``pe`` mesh.
    """

    def __init__(self, devices=None):
        self.devices = (None if devices is None
                        else tuple(torch.device(d) for d in devices))
        self.stats = TransferStats()

    def status(self, device=None) -> dict:
        if device is None and self.devices is not None:
            device = self.devices[0]
        device = resolve_device(device)
        if device.type == "cuda":
            props = torch.cuda.get_device_properties(device)
            kind, memory = props.name, props.total_memory
        else:
            kind, memory = "cpu", None
        return {"num_devices": 1 if self.devices is None
                else len(self.devices),
                "platform": device.type, "device_kind": kind,
                "device_memory_bytes": memory,
                "mesh": None if self.devices is None
                else {"shape": {"pe": len(self.devices)}}}

    def transport(self, tree: Any, device=None) -> Any:
        """Place a tensor, or a dataclass/tuple of them (a ``Graph``), on
        the device; records the bytes."""
        device = resolve_device(device)
        self.stats.record_h2d(_nbytes(tree))
        return to_device(tree, device)

    def fetch(self, tree: Any) -> Any:
        """Device → host (paper: result read-back)."""
        self.stats.record_d2h(_nbytes(tree))
        return to_device(tree, "cpu")

    def estimate_frontier_bytes(self, num_vertices: int, pes: int,
                                packed: bool = True) -> int:
        """Per-superstep mask-exchange volume per participant: with
        ``packed``, the bitmap all-gather's ``(p−1) · ceil(V/32) · 4``
        bytes, else the int8 ring's ``2·(p−1)/p · V``; 0 on one PE.
        Recorded on :attr:`TransferStats.frontier_bytes_per_superstep`."""
        if pes <= 1:
            vol = 0
        elif packed:
            vol = (pes - 1) * (-(-num_vertices // 32)) * 4
        else:
            vol = int(2 * (pes - 1) / pes * num_vertices)
        self.stats.frontier_bytes_per_superstep = vol
        return vol

    def estimate_collective_bytes(self, num_vertices: int,
                                  value_dtype: torch.dtype, pes: int,
                                  quantized: bool = False) -> int:
        """Per-superstep ring all-reduce volume per participant:
        ``2·(p−1)/p · V`` elements at ``itemsize`` bytes, at 1 byte when
        ``quantized`` plus the two float32 scale agreements; 0 on one PE
        (and then nothing is recorded).  Recorded on
        :attr:`TransferStats.collective_bytes_per_superstep`."""
        if pes <= 1:
            return 0
        itemsize = 1 if quantized else value_dtype.itemsize
        vol = int(2 * (pes - 1) / pes * num_vertices * itemsize)
        if quantized:
            vol += 2 * int(2 * (pes - 1) / pes * 4)
        self.stats.collective_bytes_per_superstep = vol
        return vol

    def report(self, device=None) -> dict:
        """Stats + status snapshot, with the partition stream's measured
        ``overlap_efficiency``."""
        return (dataclasses.asdict(self.stats)
                | {"overlap_efficiency": self.stats.overlap_efficiency()}
                | self.status(device))

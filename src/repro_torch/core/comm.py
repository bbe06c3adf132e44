"""Communication manager (paper §V-C1), single device.

Counterpart of ``repro.core.comm`` for one device: placement of graph
data on the run's device (the paper's ``Transport``), read-back, and the
transfer accounting the reports show.  The cross-PE exchange
(``quantized_psum``, ``bitmap_or``) waits for the multi-PE port
(``ROADMAP.md`` §1 item 10); with one device the collective estimates are
zero.

Entry points take ``device=None`` to mean the CUDA device, and raise when
there is none: the port never falls back to the CPU unless asked to.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

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
    """Placement bytes plus the (single-device: empty) exchange plane."""

    host_to_device_bytes: int = 0
    device_to_host_bytes: int = 0
    collective_bytes_per_superstep: int = 0
    frontier_bytes_per_superstep: int = 0
    collective_supersteps: int = 0
    collective_bytes_total: int = 0
    placements: int = 0

    def record_h2d(self, nbytes: int):
        self.host_to_device_bytes += int(nbytes)
        self.placements += 1

    def record_d2h(self, nbytes: int):
        self.device_to_host_bytes += int(nbytes)


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


class CommManager:
    """Paper: 'control shell' — a placement/transfer planner for one device."""

    def __init__(self):
        self.stats = TransferStats()

    def status(self, device=None) -> dict:
        device = resolve_device(device)
        if device.type == "cuda":
            props = torch.cuda.get_device_properties(device)
            kind, memory = props.name, props.total_memory
        else:
            kind, memory = "cpu", None
        return {"num_devices": 1, "platform": device.type,
                "device_kind": kind, "device_memory_bytes": memory}

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

    def estimate_frontier_bytes(self, num_vertices: int, pes: int) -> int:
        """Per-superstep packed-bitmap mask exchange per participant:
        ``(p−1) · ceil(V/32) · 4`` bytes, 0 on one PE."""
        vol = (pes - 1) * (-(-num_vertices // 32)) * 4
        self.stats.frontier_bytes_per_superstep = vol
        return vol

    def estimate_collective_bytes(self, num_vertices: int,
                                  value_dtype: torch.dtype, pes: int) -> int:
        """Per-superstep ring all-reduce volume per participant,
        ``2·(p−1)/p · V · itemsize`` bytes, 0 on one PE."""
        vol = int(2 * (pes - 1) / pes * num_vertices * value_dtype.itemsize)
        self.stats.collective_bytes_per_superstep = vol
        return vol

    def report(self, device=None) -> dict:
        """Stats + status snapshot."""
        return dataclasses.asdict(self.stats) | self.status(device)

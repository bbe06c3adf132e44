"""Dense ELL gather-apply-reduce: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro.kernels.edge_block``.  The TPU kernel there keeps
the vertex tables as ``(V/128, 128)`` VMEM tiles and streams
``(block_rows, W)`` edge tiles; on Hopper the tables live in device memory
(the random reads hit L2) and ``csrc/edge_block.cu`` runs one thread per
row, so the TPU tiling has no counterpart here.  The per-block early-out
variant (``block_live=``) serves the block-skipping pull plane, which is
not ported yet (``ROADMAP.md`` §2 item 2).

:func:`edge_block_reduce` takes the plain version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; it never falls back
from one to the other.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import GATHER_OPS, REDUCE_OPS, edge_block_reduce_ref

_VALUE_DTYPES = {torch.float32: 1, torch.int32: 0}


def edge_block_reduce_plain(nbr, wgt, values, degrees, active, *, gather: str,
                            reduce: str, mask_inactive: bool = True):
    """Plain PyTorch version of the kernel (the oracle it is held to)."""
    return edge_block_reduce_ref(nbr, wgt, values, degrees, active,
                                 gather=gather, reduce=reduce,
                                 mask_inactive=mask_inactive)


def edge_block_reduce(
    nbr: torch.Tensor,        # (R, W) int32 neighbor ids, PAD-padded
    wgt: torch.Tensor,        # (R, W) float32 edge weights
    values: torch.Tensor,     # (V,) int32 | float32 vertex values
    degrees: torch.Tensor,    # (V,) int32 out-degrees
    active: torch.Tensor,     # (V,) bool frontier
    *,
    gather: str,
    reduce: str,
    mask_inactive: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row reduce of the menu gather over live slots.

    Returns ``(reduced (R,) values.dtype, any_live (R,) bool)``.  Neighbor
    ids must be ``PAD`` or lie in ``[0, V)`` (the layout builders
    guarantee it; the kernel does not re-check per call).
    """
    if gather not in GATHER_OPS or reduce not in REDUCE_OPS:
        raise ValueError(f"not a menu module: gather={gather!r}, "
                         f"reduce={reduce!r}")
    if gather == "div_deg" and not values.dtype.is_floating_point:
        raise ValueError("div_deg is a true division: it needs float values")
    if values.device.type == "cpu":
        return edge_block_reduce_plain(nbr, wgt, values, degrees, active,
                                       gather=gather, reduce=reduce,
                                       mask_inactive=mask_inactive)
    if values.device.type != "cuda":
        raise ValueError(f"edge_block_reduce runs on CPU or CUDA tensors, "
                         f"got {values.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    R, W = nbr.shape
    V = values.shape[0]
    want = {"nbr": (nbr, torch.int32, (R, W)),
            "wgt": (wgt, torch.float32, (R, W)),
            "values": (values, values.dtype, (V,)),
            "degrees": (degrees, torch.int32, (V,)),
            "active": (active, torch.bool, (V,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != values.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {values.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    out = torch.empty((R,), dtype=values.dtype, device=values.device)
    any_live = torch.empty((R,), dtype=torch.uint8, device=values.device)
    if R == 0:
        return out, any_live.view(torch.bool)
    lib = _build.library("edge_block")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.edge_block_reduce_launch(
        values.device.index or 0, GATHER_OPS.index(gather),
        REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype],
        int(mask_inactive), nbr.data_ptr(), wgt.data_ptr(),
        values.data_ptr(), degrees.data_ptr(), active.data_ptr(),
        out.data_ptr(), any_live.data_ptr(), R, W, stream)
    if err != 0:
        raise RuntimeError(f"edge_block kernel launch failed: "
                           f"cudaError_t {err}")
    edge_block_reduce.launches += 1
    return out, any_live.view(torch.bool)


# launches of the CUDA kernel since the count was last set to 0
edge_block_reduce.launches = 0

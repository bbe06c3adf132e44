"""Menu-name conveniences over the kernel modules.

Counterpart of ``repro.kernels.ops`` for tests and direct callers (the
translator stages the modules itself).  The kernel wrappers dispatch by
device on their own — ``edge_block.edge_block_reduce`` and
``push_ell.push_ell_message_block`` take their plain version for CPU
tensors and launch their CUDA kernel for CUDA tensors — so the one
convenience left here is the compacted push reduce with the reduce
identity folded from the menu names.
"""
from __future__ import annotations

from functools import partial

import torch

from . import push_ell as _push_ell
from . import ref as _ref


def push_ell_reduce(row_src, ell_dst, ell_wgt, values, degrees, active, *,
                    num_rows, capacity, gather, reduce, mask_inactive=True,
                    emit_touched=True):
    """Frontier-compacted forward-ELL push reduce (menu-gather dispatch).

    The reduce identity is folded here and ``emit_touched`` defaults on,
    so the result matches ``ref.push_scatter_reduce_ref``; the message
    stage is the CUDA kernel exactly when the tensors are on a CUDA
    device.
    """
    if not mask_inactive:
        active = torch.ones_like(active)
    return _push_ell.push_ell_reduce(
        row_src, ell_dst, ell_wgt, values, degrees, active,
        num_rows=num_rows, capacity=capacity,
        gather_fn=partial(_ref.gather_msg, gather), reduce=reduce,
        identity=_ref._identity(reduce, values.dtype),
        num_vertices=values.shape[0], dtype=values.dtype,
        gather_module=gather, use_kernels=values.device.type == "cuda",
        emit_touched=emit_touched)

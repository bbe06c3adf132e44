"""One-query flash-decode GQA attention: the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.decode_gqa``.  The TPU kernel swaps the
caches to ``(B, K, S, h)`` so that its ``(block_s, h)`` sequence tiles are
contiguous, and carries the running ``(m, l, acc)`` across a sequential
grid axis in its output refs.  On the card that swap would copy the whole
cache every layer and step, so ``csrc/decode_gqa.cu`` reads the caches in
place, in their ``(B, S, K, h)`` layout with strides, and splits each
row's slots over several thread blocks (flash-decoding): each block
carries the online softmax over its tile-aligned share of the row, and a
second small kernel merges the blocks' float32 partials.
:func:`split_plan` chooses the tile and the number of splits from the
shapes and the SM count alone, never from ``length``, which stays on the
device.

:func:`decode_gqa` takes the plain version (``ref.decode_gqa_ref``) for
tensors on the CPU and launches the kernel for tensors on a CUDA device;
it never falls back from one to the other.  A ``meta`` tensor (the dry
run's trace, ``launch/costing.py``) goes through the plain version for
its result's shape and dtype; nothing runs and the kernel's loader is
never reached.  The decode step of every
served attention layer calls it once (``models.layers.attention_decode``),
``global`` and ``local`` alike, soft-capped where the config says.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import decode_gqa_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WARP_SLOTS = 16            # slots a warp takes from each tile
GROUP = 8                  # query heads a block takes (the mma's N)
_STAGES = 3                # the cp.async ring of each warp
_SMEM_BYTES = 210 * 1024   # the shared memory a block may plan on
_SM_SMEM_BYTES = 228 * 1024     # an SM's shared memory, 1 KB a block reserved


@functools.lru_cache(maxsize=None)
def split_plan(B: int, S: int, K: int, G: int, h: int, elem_size: int,
               sms: int) -> tuple[int, int]:
    """``(warps, splits)`` of the kernel's launch: warps a block (its tile
    is ``16 * warps`` slots), and blocks a row of ``(b, k, group of 8
    query heads)``.  Four warps unless their cp.async rings outgrow a
    block's shared memory; splits enough for the blocks that the card's
    SMs hold at once, but no more (a partial second wave costs as much as
    the first), and at most one a tile of the capacity ``S``."""
    hp = -(-h // 16) * 16
    row_bytes = (hp + 16 // elem_size) * elem_size
    ring = 2 * _STAGES * WARP_SLOTS * row_bytes
    warps = 4
    while warps > 1 and warps * ring > _SMEM_BYTES:
        warps //= 2
    # the kernel's shared memory: q, then each warp's rings, p tiles and
    # positions (csrc/decode_gqa.cu)
    smem = GROUP * row_bytes + warps * (
        ring + 2 * GROUP * 24 * elem_size + _STAGES * WARP_SLOTS * 4)
    # blocks an SM holds: by shared memory, and by registers (at most 128
    # a thread: four 4-warp blocks)
    per_sm = max(1, min(_SM_SMEM_BYTES // (smem + 1024), 16 // warps))
    rows = B * K * -(-G // GROUP)
    tiles = -(-S // (WARP_SLOTS * warps))
    splits = max(1, min(per_sm * sms // max(rows, 1), tiles))
    return warps, splits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_gqa(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: torch.Tensor, length: torch.Tensor, *,
               scale: float | None = None,
               softcap: float = 0.0) -> torch.Tensor:
    """``(B, K, G, h)`` attention of ``q`` over the slots ``s`` of
    ``k_cache``/``v_cache`` ``(B, S, K, h)`` with ``s < length[b]`` and
    ``pos[b, s] >= 0``, scaled by ``scale`` (default ``h ** -0.5``), in
    q's dtype.  A nonzero ``softcap`` ``c`` caps each scaled score ``s``
    as ``c * tanh(s / c)`` before the mask and the softmax (the JAX
    package's ``_attn_core`` with ``attn_softcap``).

    The kernel takes float32 or bfloat16 (q and caches of one dtype) and
    ``h`` a multiple of 8 up to 256; it reads the caches
    through their strides (unit stride over ``h``, 16-byte aligned rows).
    It computes in float32 with an online softmax, and a masked slot, even
    one holding NaN, contributes nothing.  A row with no valid slot (no
    caller on the decode path makes one: the current token is written
    first) gives zeros, where the plain version gives NaN.
    """
    B, S, K, h = k_cache.shape
    G = q.shape[2]
    scale = float(scale) if scale is not None else h ** -0.5
    softcap = float(softcap)
    if q.device.type in ("cpu", "meta"):
        # meta: the result's shape and dtype only (the dry run's trace);
        # nothing executes, so nothing falls back
        return decode_gqa_ref(q, k_cache, v_cache, pos, length, scale=scale,
                              softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_gqa runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if h % 8 or not 0 < h <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes h a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got h={h}")
    if tuple(q.shape) != (B, K, G, h):
        raise ValueError(f"q: want ({B}, {K}, G, {h}), got {tuple(q.shape)}")
    vec = 16 // q.element_size()          # elements in 16 bytes
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != q.dtype \
                or tuple(t.shape) != (B, S, K, h) or t.stride(3) != 1 \
                or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: want {q.dtype} ({B}, {S}, {K}, {h}) on {q.device} "
                f"with unit stride over h and 16-byte aligned rows, got "
                f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on "
                f"{t.device}")
    for name, t, shape in (("pos", pos, (B, S)), ("length", length, (B,))):
        if t.device != q.device or t.dtype != torch.int32 \
                or tuple(t.shape) != shape or t.stride(-1) != 1:
            raise ValueError(f"{name}: want int32 {shape} on {q.device} with "
                             f"unit last stride, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()} on "
                             f"{t.device}")
    q = q.contiguous()
    out = torch.empty((B, K, G, h), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    warps, splits = split_plan(B, S, K, G, h, q.element_size(),
                               _sm_count(index))
    # float32 (m[8], l[8], acc[8, h]) of every (row, split), merged by the
    # combine kernel; one split writes the output directly
    part = None if splits == 1 else torch.empty(
        (B * K * -(-G // GROUP) * splits * GROUP * (h + 2),),
        dtype=torch.float32, device=q.device)
    lib = _build.library("decode_gqa")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_gqa_launch(
        index, _DTYPES[q.dtype], B, S, K, G, h, warps, splits, scale,
        softcap, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        pos.data_ptr(), pos.stride(0), length.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode_gqa kernel launch failed: cudaError_t "
                           f"{err}")
    decode_gqa.launches += 1
    if softcap:
        decode_gqa.softcap_launches += 1
    return out


# launches of the CUDA kernel since the counts were last set to 0: all,
# and those of its soft-capped instantiation
decode_gqa.launches = 0
decode_gqa.softcap_launches = 0

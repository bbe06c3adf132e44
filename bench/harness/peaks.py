"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 data sheet (SXM part, at the full 700 W power limit):
3.35 TB/s of HBM3 bandwidth.  A card run below that limit reaches less;
the share is still stated against this peak.
"""
from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, key: str) -> float | None:
    """The peak ``key`` of the card called ``kind`` (the name
    ``torch.cuda.get_device_name`` gives); ``None`` for an unknown card."""
    for family, table in PEAKS.items():
        if family in kind:
            return table[key]
    return None

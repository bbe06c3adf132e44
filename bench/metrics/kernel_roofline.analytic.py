"""The traced searches' least bytes (``bench/harness/roofline.py``) at
the card's peak bandwidth, as a percent of the device's busy time."""
from bench.harness import peaks, roofline


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    traced = [s for s in rec.searches if s["traced"]]
    bw = peaks.peak(rec.device_kind, "hbm_bytes_per_s")
    if not traced or bw is None:
        return None
    least = sum(roofline.bfs_search_bytes(s["edges"], rec.num_vertices)
                for s in traced)
    return 100.0 * least / bw / rec.trace.busy_s

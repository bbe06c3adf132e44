from . import (decode_gqa, edge_block, ops, pull_bitmap, push_ell,
               push_scatter, ref, segment_sum)

__all__ = ["decode_gqa", "edge_block", "ops", "pull_bitmap", "push_ell",
           "push_scatter", "ref", "segment_sum"]

from . import (edge_block, ops, pull_bitmap, push_ell, push_scatter, ref,
               segment_sum)

__all__ = ["edge_block", "ops", "pull_bitmap", "push_ell", "push_scatter",
           "ref", "segment_sum"]

from . import edge_block, ops, pull_bitmap, push_ell, ref

__all__ = ["edge_block", "ops", "pull_bitmap", "push_ell", "ref"]

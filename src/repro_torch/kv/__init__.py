from .paged import (BranchBlocks, OutOfPagesError, PageAllocator,
                    tree_decode_map)
from .prefix_cache import CacheNode, PrefixCache, default_page_hash

__all__ = ["BranchBlocks", "OutOfPagesError", "PageAllocator",
           "CacheNode", "PrefixCache", "default_page_hash",
           "tree_decode_map"]

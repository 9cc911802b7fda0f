from .paged import (BranchBlocks, OutOfPagesError, PageAllocator,
                    tree_decode_map)

__all__ = ["BranchBlocks", "OutOfPagesError", "PageAllocator",
           "tree_decode_map"]

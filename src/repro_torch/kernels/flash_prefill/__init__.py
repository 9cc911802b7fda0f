"""Paged flash-prefill (K2): ``ops.paged_flash_prefill`` dispatches."""

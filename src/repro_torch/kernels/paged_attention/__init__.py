"""Paged flash-decode (K1): ``ops.paged_attention`` dispatches."""

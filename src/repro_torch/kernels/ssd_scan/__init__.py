"""Mamba-2 SSD chunked scan (K4): ``ops.ssd`` and ``ops.ssd_with_state``
dispatch."""

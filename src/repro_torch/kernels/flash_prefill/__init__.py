"""Dense flash prefill (K5) and paged flash-prefill (K2); ``ops``
dispatches."""

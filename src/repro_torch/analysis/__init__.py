"""Stdlib-only instrumentation of the PyTorch port."""

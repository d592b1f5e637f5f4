"""Pallas GPU kernels for the hot path (the full-path megakernel)."""

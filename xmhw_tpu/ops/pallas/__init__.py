"""Pallas GPU kernels for hot paths."""

"""Kernels and attention primitives."""

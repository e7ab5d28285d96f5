"""Pallas GPU kernels (Triton route) — the performance path for the step."""

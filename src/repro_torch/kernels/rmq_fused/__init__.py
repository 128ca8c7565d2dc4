"""Fused query batch: value and position planes in one CUDA launch (B2)."""

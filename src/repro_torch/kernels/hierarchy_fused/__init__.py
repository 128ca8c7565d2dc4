"""Fused hierarchy build: every upper level in one CUDA launch (B1)."""

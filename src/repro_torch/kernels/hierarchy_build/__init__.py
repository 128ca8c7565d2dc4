"""Per-level hierarchy build: one CUDA launch per upper level (B3)."""

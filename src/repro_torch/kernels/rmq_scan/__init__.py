"""The paper's CL+WLQ query scan: one CUDA launch per output plane (B4)."""

"""Causal GQA flash attention with an optional sliding window (B8)."""

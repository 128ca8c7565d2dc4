"""Mamba-2 SSD chunk scan (B9)."""

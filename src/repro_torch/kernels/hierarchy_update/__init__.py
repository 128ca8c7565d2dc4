"""Scattered chunk re-reduction for hierarchy updates (B6)."""

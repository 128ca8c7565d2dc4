"""Bulk queries over an endpoint-sorted batch with chunk reuse (B7)."""

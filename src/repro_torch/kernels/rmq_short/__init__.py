"""Short-span queries from their two level-0 chunks (B5)."""

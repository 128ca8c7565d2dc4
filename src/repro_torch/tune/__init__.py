"""Workload generators of the port (the autotuner itself is ROADMAP A9)."""

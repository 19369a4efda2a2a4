"""Workload data for the port (synthetic paper corpora so far)."""

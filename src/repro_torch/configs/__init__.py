"""Experiment configurations of the port (the paper's workloads)."""

"""Experiment configurations of the port: the paper's workloads and the
model architectures (``registry``)."""

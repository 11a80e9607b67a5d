"""Data pipeline of the port: ``pipeline.SyntheticLM`` and ``pipeline.TokenFileDataset``."""

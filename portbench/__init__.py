"""The benchmark of ``repro_torch``'s evaluator on one H100: see README.md."""

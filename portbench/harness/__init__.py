"""The benchmark's general code: manifest, traffic, run, trace, work."""

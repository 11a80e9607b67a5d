"""Launchers of the port: serving on one device (``serve``)."""

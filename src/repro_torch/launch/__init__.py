"""Launchers of the port: serving (``serve``), training (``train``) and the
paper's studies (``study``)."""

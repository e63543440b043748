"""Launchers of the port (``repro/launch``): the serving driver."""

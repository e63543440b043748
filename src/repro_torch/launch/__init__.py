"""Launchers of the port (``repro/launch`` and the ``examples`` programs):
serving, round tracing and federated LM training."""

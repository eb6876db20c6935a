"""Tooling around the port: the performance-measurement harness
(``perftest``)."""

"""Observability of the port: metric names and the Prometheus registry."""

"""Observability of the port: the device metrics plane's host half."""

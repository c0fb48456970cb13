"""Utilities of the port: the device prefetcher of the token pipeline
(data.py)."""

"""Utilities of the port: the token pipeline (data.py: TokenDataset and the
device prefetcher), the section profiler (profiler.py) and checkpoints
(checkpoint.py)."""

"""Utilities of the port: the token pipeline (data.py: TokenDataset and the
device prefetcher), the section profiler (profiler.py), checkpoints
(checkpoint.py) and the process's own peak host memory (rss.py)."""

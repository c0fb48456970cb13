"""Utilities of the port: the token pipeline (data.py: TokenDataset and the
device prefetcher), the section profiler (profiler.py), checkpoints
(checkpoint.py), the process's own peak host memory (rss.py) and the
leveled logger (logging.py)."""

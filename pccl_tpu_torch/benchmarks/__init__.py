"""Benchmarks on the card: the train step's tokens/s and MFU (model_bench),
H1 against the staging digest (hash_bench), and the twin of the repo's
bench.py (bench). Importing this package loads nothing heavy."""

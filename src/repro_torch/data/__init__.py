"""Synthetic data shards (NumPy)."""

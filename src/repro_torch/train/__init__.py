"""Optimizers of the SL loop."""

"""Continuous-batching decode engine."""

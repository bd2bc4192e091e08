"""Split-model serving."""

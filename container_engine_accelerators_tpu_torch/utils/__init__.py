"""Utilities of the PyTorch port: checkpoints (checkpoint.py)."""

"""Utilities of the PyTorch port: checkpoints (checkpoint.py) and the
fake GPU node (fake_node.py)."""

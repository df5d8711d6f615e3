"""Utilities of the training loop."""

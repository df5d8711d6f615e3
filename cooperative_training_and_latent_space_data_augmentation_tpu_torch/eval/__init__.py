"""Validation and held-out evaluation metrics, and the tester."""

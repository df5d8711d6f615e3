"""Validation metrics."""

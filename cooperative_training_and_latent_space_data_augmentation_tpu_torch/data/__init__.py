"""Synthetic phantom data, made from a seed with numpy."""

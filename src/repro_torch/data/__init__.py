"""Synthetic token pipeline of the port (numpy, seekable by step)."""

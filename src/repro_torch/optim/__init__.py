"""Optimizer of the port: AdamW with fp32 moments, updated in place."""

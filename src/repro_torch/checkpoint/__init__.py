"""Atomic, async checkpoints of the port's train state."""

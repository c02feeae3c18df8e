"""Atomic, versioned checkpoints of the port."""

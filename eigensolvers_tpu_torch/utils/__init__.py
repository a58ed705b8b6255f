"""Shared numerics, units, reporting, status, checkpointing."""

"""Checkpoints of the port (counterpart of ``repro/checkpoint``), in the
reference's on-disk layout."""

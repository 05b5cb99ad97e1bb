"""Checkpoints of the port: ``manager.CheckpointManager``."""

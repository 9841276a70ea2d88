"""Host utilities: scan checkpoints."""

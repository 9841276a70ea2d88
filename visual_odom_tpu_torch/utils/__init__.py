"""Host utilities: checkpoints (scan and ``VisualOdometry``) and metrics."""

"""Host utilities: checkpoints (scan, batched and ``VisualOdometry``),
metrics, the eval notifier and profiling hooks."""

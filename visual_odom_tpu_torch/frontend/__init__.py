"""Feature state, detection + bucketing, and circular matching."""

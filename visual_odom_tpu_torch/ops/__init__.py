"""Image operators: pyramids, FAST, and the circular-quad LK kernel."""

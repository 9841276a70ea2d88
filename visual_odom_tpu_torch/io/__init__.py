"""Synthetic stereo input."""

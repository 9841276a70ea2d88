"""Trajectory and track rendering."""

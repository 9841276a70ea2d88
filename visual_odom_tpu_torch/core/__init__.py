"""Geometry primitives: SO(3)/SE(3), small SPD solves, triangulation."""

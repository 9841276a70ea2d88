"""Windowed bundle adjustment and the keyframe pose graph."""

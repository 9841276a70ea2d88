"""Synthetic stereo input and KITTI pose files."""

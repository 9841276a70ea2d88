"""Pose estimation (PnP-RANSAC) and the acceptance gates."""

"""Mapping back-end: bundle adjustment and keyframe map management."""

"""Intersection, closures and gathers."""

"""Renderer, estimator and public API."""

"""Utilities: configuration and metrics."""

"""Resilience: the rollback-and-skip vocabulary (``poison.py``) the guard's host side uses."""

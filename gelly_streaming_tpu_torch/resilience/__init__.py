"""Failure types of the port (resilience layer)."""

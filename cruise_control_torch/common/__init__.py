"""Shared taxonomy (resources, metrics, broker states)."""

"""Balancing constraints."""

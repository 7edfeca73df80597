"""Breakage scoring."""

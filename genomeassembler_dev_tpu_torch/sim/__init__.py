"""Segments and read simulation."""

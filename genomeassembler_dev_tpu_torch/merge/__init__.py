"""Ordering-ensemble merge through the shared native engine."""

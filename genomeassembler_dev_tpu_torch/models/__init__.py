"""Breakage-probability models: the static QueryTable model and a trainable
neural surrogate."""

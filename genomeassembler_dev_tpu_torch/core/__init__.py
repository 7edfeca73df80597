"""Encoding and the breakage-probability QueryTable."""

"""Tensor operations: windows, matching, KS, edit distance."""

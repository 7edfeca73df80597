"""String-level executable spec of the reference's ordering-ensemble merge."""

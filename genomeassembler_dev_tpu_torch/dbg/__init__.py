"""De Bruijn graph construction and contig walks."""

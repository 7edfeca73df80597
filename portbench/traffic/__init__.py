"""The benchmark's traffic: frozen segment generators."""

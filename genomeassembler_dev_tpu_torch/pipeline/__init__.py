"""Experiment configuration and the per-experiment orchestrator."""

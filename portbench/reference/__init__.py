"""The plain reference that decides whether a run's outputs are correct
(NumPy and plain PyTorch; it imports nothing of the program)."""

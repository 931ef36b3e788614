"""The plain references of the benchmark's checks: PyTorch and NumPy alone,
nothing of the program."""

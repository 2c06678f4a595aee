"""Plain PyTorch / NumPy references the benchmark holds the program to.

Nothing here imports the program under test."""

"""The benchmark of the PyTorch / CUDA port (``run.py`` runs one cell)."""

"""The plain reference of the benchmark: plain PyTorch and NumPy, importing
nothing of the port."""

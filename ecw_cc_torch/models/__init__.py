"""Models: ERIs, target generation and the ECW driver (PyTorch port)."""

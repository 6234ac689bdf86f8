"""Tensor kernels of the ECW-CCSD solve (PyTorch port)."""

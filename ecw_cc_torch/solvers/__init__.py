"""Ground-state solvers (PyTorch port)."""

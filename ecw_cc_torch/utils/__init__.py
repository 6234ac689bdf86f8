"""Host utilities of the PyTorch port: format conversions, property
evaluators, iteration metrics, checkpoints and cube/table output."""

"""Multi-device parallelism: device meshes and placement rules for the CC
tensors, on torch.distributed and DTensor."""

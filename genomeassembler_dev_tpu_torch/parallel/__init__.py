"""Multi-device scale-out on torch.distributed: meshes, sharded pipeline
steps, sharded tables."""

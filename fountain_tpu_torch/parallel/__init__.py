"""Multi-process parallelism: pixel-sharded rendering over torch.distributed."""

"""Multi-process plumbing and the point-sharded bundle adjustment
(counterpart of colmap_tpu/parallel) on torch.distributed."""

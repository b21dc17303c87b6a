"""Tensor and data parallelism over torch.distributed (parallel/mesh.py,
parallel/tp.py, parallel/collectives.py)."""

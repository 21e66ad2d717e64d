"""Fused operators of the port. Each wrapper launches its hand-written
CUDA kernel on a CUDA tensor and takes its plain PyTorch version on a
CPU tensor."""

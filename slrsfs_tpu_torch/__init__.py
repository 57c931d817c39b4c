"""PyTorch/CUDA port of slrsfs_tpu for NVIDIA Hopper GPUs (baseline render path)."""

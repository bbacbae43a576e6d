"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(`ref`), and the device dispatch with launch counters (`ops`)."""

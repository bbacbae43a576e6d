"""PyTorch/CUDA port of IEMAS (the JAX package `repro` is the reference):
the router's per-batch step and the agents' real serving engine (the dense
GQA family, ``qwen3-8b``).

The port keeps the reference's module layout and names.  Its device work
runs on ``device=`` (default ``"cuda"``): the hand-written Hopper kernels in
`repro_torch.kernels` for CUDA tensors, their plain PyTorch versions for CPU
tensors.  It imports neither JAX nor anything of `repro`.
"""

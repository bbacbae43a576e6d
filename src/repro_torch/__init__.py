"""PyTorch/CUDA port of the IEMAS router (the JAX package `repro` is the
reference).

The port keeps the reference's module layout and names.  Its device work
runs on ``device=`` (default ``"cuda"``): the hand-written Hopper kernels in
`repro_torch.kernels` for CUDA tensors, their plain PyTorch versions for CPU
tensors.  It imports neither JAX nor anything of `repro`.
"""

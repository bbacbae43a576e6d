"""PyTorch/CUDA port of IEMAS (the JAX package `repro` is the reference):
the router, the agents' real serving engines (the dense GQA family,
RWKV-6 and zamba2), and the serving stack over them — the simulated
cluster, the closed-loop and event-driven serving loops, the hubs-of-hubs
federation of super-hub shards (inline or one process each), the
baselines and adversaries, and the serving launcher (``python -m
repro_torch.launch.serve``).

The port keeps the reference's module layout and names.  Its device work
runs on ``device=`` (default ``"cuda"``): the hand-written Hopper kernels in
`repro_torch.kernels` for CUDA tensors, their plain PyTorch versions for CPU
tensors.  It imports neither JAX nor anything of `repro`.
"""

"""Which collectives two gloo ranks sharing one CUDA card can run.

Starts two processes on ``cuda:0`` joined by gloo over localhost and, in
each, runs every ``torch.distributed`` collective the split training step
could use (all-reduce, the list and tensor forms of all-gather and
reduce-scatter, broadcast, scatter) on float32 and bf16 CUDA tensors, then
DTensor's ``full_tensor``, ``redistribute`` (Partial to Shard) and
``distribute_tensor`` over a (1, 2) mesh.  Each result is printed as it
comes, so a collective that crashes the process is the last line before
the crash.  With torch 2.11 on an H100 machine every plain collective ran
and DTensor's ``full_tensor`` crashed both processes (a segmentation
fault in the functional collectives' wait), which is why
`repro_torch.training.loop` gathers and reduces with the plain ones.

Run on a machine with a CUDA card:

    python3 tools/gloo_cuda_probe.py
"""
from __future__ import annotations

import socket
import subprocess
import sys

CHILD = r'''
import faulthandler, sys
import torch
import torch.distributed as dist
faulthandler.enable()
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
dev = torch.device("cuda", 0)


def probe(name, fn):
    try:
        out = fn()
        torch.cuda.synchronize()
        res = "ok " + str(out)[:60]
    except Exception as e:  # noqa: BLE001 — the probe reports it
        res = f"FAIL {type(e).__name__}: {str(e)[:150]}"
    print(rank, name, res, flush=True)


for dt in (torch.float32, torch.bfloat16):
    n = str(dt).removeprefix("torch.")
    x = torch.arange(8, device=dev, dtype=dt) + 10 * rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y.tolist()

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts).tolist()

    def all_gather_into_tensor():
        out = torch.empty(16, device=dev, dtype=dt)
        dist.all_gather_into_tensor(out, x)
        return out.tolist()

    def reduce_scatter():
        out = torch.empty(4, device=dev, dtype=dt)
        dist.reduce_scatter(out, list(x.chunk(2)))
        return out.tolist()

    def reduce_scatter_tensor():
        out = torch.empty(4, device=dev, dtype=dt)
        dist.reduce_scatter_tensor(out, x)
        return out.tolist()

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y.tolist()

    def scatter():
        out = torch.empty(4, device=dev, dtype=dt)
        dist.scatter(out, list(x.chunk(2)) if rank == 0 else None, src=0)
        return out.tolist()

    for fn in (all_reduce, all_gather, all_gather_into_tensor,
               reduce_scatter, reduce_scatter_tensor, broadcast, scatter):
        probe(f"{fn.__name__} {n}", fn)

from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
x = torch.arange(8.0, device=dev)
probe("DTensor full_tensor", lambda: DTensor.from_local(
    x.chunk(2)[rank].contiguous(), mesh,
    (Replicate(), Shard(0))).full_tensor().tolist())
probe("DTensor redistribute Partial -> Shard", lambda: DTensor.from_local(
    x + rank, mesh, (Replicate(), Partial("sum"))).redistribute(
    mesh, (Replicate(), Shard(0))).to_local().tolist())
probe("distribute_tensor Shard", lambda: distribute_tensor(
    x, mesh, (Replicate(), Shard(0))).to_local().tolist())
dist.destroy_process_group()
'''


def main() -> int:
    import torch

    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.device_count())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        for p in procs:
            print(p.communicate(timeout=240)[0])
            print("exit code", p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())

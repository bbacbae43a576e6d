"""Process-parallel substrate for the hubs-of-hubs federation.

The federation's shards (`repro_torch.serving.federation.InlineShard`) are
analytically-engined event loops whose routers run on ``ShardSpec.device``
(the card, by default), so they parallelize across OS processes: this
module provides the deterministic per-shard seed split, the picklable
`ShardSpec` a worker needs to build its shard from scratch, and
`ProcessShardHandle` — a pipe-RPC proxy exposing the exact `InlineShard`
surface, so `repro_torch.serving.federation.FederatedSimulator` drives
inline and remote shards through one interface.

Seed splitting (`shard_seed`) is `fold_in`-style: the base seed and the
super-hub id are folded through a specified, platform-stable mix
(`numpy.random.SeedSequence`), so every shard owns an independent RNG
stream derived ONLY from ``(base_seed, super_id)`` — never from
scheduling order — and equal to the reference package's split.  Since
shards share no mutable random state (each `SimCluster` carries its own
generator) a federated run is bit-deterministic under ANY shard-advance
interleave, which is what lets the process pool below overlap shard
execution freely between epochs.

Placement: every process shard on a CUDA device opens its own CUDA context
on that device, so S shards on one card time-slice it; the workers start
with ``spawn`` (a CUDA context cannot cross ``fork``) and build their
cluster and router inside the child.  The parent builds the router's
kernel libraries before any worker starts (`build_router_kernels`), so the
children load them instead of each compiling them.  `worker_slots` bounds
process fan-out by visible cores.  Kernel launch counts
(`repro_torch.kernels.ops.launch_counts`) are per process: a process
shard's launches are not visible to the parent.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from dataclasses import dataclass, field

import numpy as np

#: the kernel libraries an IEMAS router can launch (staged and fused steps)
ROUTER_KERNELS = ("lcp_affinity", "auction_bid", "routing_fused")


def shard_seed(base_seed: int, super_id: int) -> int:
    """Fold a super-hub id into the base seed (`fold_in`-style).

    `numpy.random.SeedSequence` entropy mixing is specified and
    platform-stable, so the same ``(base_seed, super_id)`` pair yields
    the same 31-bit seed on every machine — and distinct pairs are
    decorrelated far beyond what ``base_seed + super_id`` would give.
    """
    ss = np.random.SeedSequence((int(base_seed), int(super_id)))
    return int(ss.generate_state(1, np.uint32)[0] % (2**31))


def worker_slots(requested: int | None = None) -> int:
    """Bound process fan-out by visible CPU cores (at least one)."""
    cores = os.cpu_count() or 1
    return max(1, min(requested or cores, cores))


def build_router_kernels() -> dict[str, str]:
    """Build the router's kernel libraries in this process (once, before
    process shards on a CUDA device start: each child then loads them
    instead of compiling its own); returns the build reports."""
    from repro_torch.kernels import build

    return build.build(ROUTER_KERNELS)


@dataclass
class ShardSpec:
    """Everything a worker process needs to build one federation shard.

    Pure data (profiles are frozen dataclasses of scalars/tuples, the
    device a string), so the spec pickles across a spawn boundary; the
    worker materializes the `SimCluster`/`IEMASRouter`/`ShardEventLoop`
    triple itself on ``device`` via
    `repro_torch.serving.federation.InlineShard.from_spec` — the SAME
    factory the inline path uses, which is what keeps process-parallel runs
    bit-identical to inline runs.
    """

    super_id: int
    profiles: list                      # this shard's slice of the fleet
    seed: int                           # shard_seed(base_seed, super_id)
    router_kwargs: dict = field(default_factory=dict)
    loop_kwargs: dict = field(default_factory=dict)
    cluster_kwargs: dict = field(default_factory=dict)
    device: str = "cuda"                # where the shard's router runs


def _shard_worker(conn, spec: ShardSpec) -> None:
    """Worker main: build the shard, then serve pipe-RPC until ``close``.

    Imports the serving stack lazily (inside the process); the RPC
    protocol is ``(method_name, args tuple)`` in, ``("ok", result)`` /
    ``("err", repr)`` out.  Every result is host data (NumPy arrays,
    Python scalars, dataclasses of them): no tensor crosses the pipe.
    """
    try:
        from repro_torch.serving.federation import InlineShard

        shard = InlineShard.from_spec(spec)
        conn.send(("ok", None))
    except Exception as e:          # pragma: no cover - startup failure path
        conn.send(("err", repr(e)))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:            # parent died: exit quietly
            return
        if msg is None:
            return
        name, args = msg
        try:
            conn.send(("ok", getattr(shard, name)(*args)))
        except Exception as e:
            conn.send(("err", repr(e)))


class ProcessShardHandle:
    """One federation shard living in its own OS process (pipe-RPC proxy).

    Exposes the `InlineShard` control surface (``start``, ``inject``,
    ``advance``, ``digest``, ``residuals``, ``extract``, ``admit``,
    ``close_arrivals``, ``finalize``) by forwarding each call over a
    duplex pipe.  Calls are synchronous by default; ``advance`` can be
    split into `advance_async` + `wait` so the parent overlaps all
    shards' epoch work — the actual concurrency win.  Uses the spawn
    start method: a child on the card needs its own CUDA context, which
    cannot be inherited through ``fork``.
    """

    def __init__(self, spec: ShardSpec, *, ctx: str = "spawn"):
        self.super_id = spec.super_id
        context = mp.get_context(ctx)
        self._conn, child = context.Pipe()
        self._proc = context.Process(target=_shard_worker,
                                     args=(child, spec), daemon=True)
        self._proc.start()
        child.close()
        self._pending = False
        self._started = False

    def ready(self) -> None:
        """Wait for the worker's startup ack (once); raises if the worker
        failed to build its shard.  The constructor does not wait, so a
        caller starts every worker first and then waits for all of them:
        the workers import and build their shards concurrently.  Every
        call through the handle waits here first."""
        if self._started:
            return
        try:
            status, payload = self._conn.recv()     # startup ack
        except EOFError:
            status, payload = "err", "worker exited before its ack"
        if status != "ok":
            raise RuntimeError(f"shard {self.super_id} worker failed to "
                               f"start: {payload}")
        self._started = True

    def _call(self, name: str, *args):
        self.ready()
        self._conn.send((name, args))
        status, payload = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"shard {self.super_id}.{name}: {payload}")
        return payload

    def advance_async(self, t_end: float | None) -> None:
        """Kick off one epoch's advance without waiting for the result."""
        self.ready()
        self._conn.send(("advance", (t_end,)))
        self._pending = True

    def wait(self):
        """Collect the result of the outstanding `advance_async`."""
        if not self._pending:
            raise RuntimeError("wait() without a pending advance_async()")
        self._pending = False
        status, payload = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"shard {self.super_id}.advance: {payload}")
        return payload

    def close(self) -> None:
        """Shut the worker down (idempotent)."""
        if self._proc.is_alive():
            try:
                self._conn.send(None)
            except (BrokenPipeError, OSError):
                pass
            self._proc.join(timeout=10)
            if self._proc.is_alive():   # pragma: no cover - hung worker
                self._proc.terminate()
        self._conn.close()

    def __getattr__(self, name):
        # proxy the remaining InlineShard surface verbatim
        if name.startswith("_"):
            raise AttributeError(name)

        def method(*args):
            return self._call(name, *args)

        return method

"""The bytes a traced step moves, counted per fused region, as the
reference's dry run reads XLA's ``bytes accessed`` of its compiled, fused
step (`launch/dryrun.py`).

``ByteCounter`` is a dispatch mode that records every op of a trace
(under fake tensors nothing runs) and counts when the trace is done:

* An op that moves nothing counts nothing: a view or a reshape that
  keeps its storage (``_unsafe_view``, ``lift_fresh``, ``detach``,
  ``alias``), and an op that returns no tensor and writes none
  (``prim.device``, which autograd asks of every tensor, and the other
  metadata queries).
* Elementwise ops (``pointwise``-tagged ones, dtype casts, copies,
  ``where``, concatenation and padding, and the factories: a constant, a
  fill, an iota) join into one region through each intermediate that only
  elementwise ops of the same pass read (a pass: the forward, one
  autograd node's backward formula, one micro-batch's gradient sum),
  unless a path would leave the region and come back (a region runs as one
  kernel).  So the sums autograd forms of a tensor's gradients, which
  arrive from layers apart, are each a region, as the reference's scan
  over layers writes its carry each step.  A region reads each
  distinct outside input once and writes the intermediates that escape:
  those the graph saves for the backward, those that outlive the trace
  (``keep``, and the last version of a tensor that was there before the
  trace and was written in place) and those an op outside it reads.
* A reduction (``reduction``-tagged ops and softmax) is a region of its
  own that reads the inputs of the elementwise chain feeding it, as XLA
  fuses such a chain into a reduction's input.
* Any other op (a matmul, a gather, a scatter, an embedding, a sort) is a
  region of its own that reads its inputs and writes its outputs; one that
  writes into a tensor in place (an indexed put or add, a scatter) writes
  as many elements of it as its update holds, and reads them too where it
  accumulates.
* A kernel op (`kernels/ops.py`: the attention, the decode attention, the
  two scans, and the backwards of the three that train) is a region whose
  bytes are its kernel's own (`kernels/work.py`); the plain version it
  runs here is not counted (``kernel_regions``).
* An op whose outputs nothing reads and nothing keeps counts nothing.

A region wholly inside a checkpointed layer's forward (``rerun``) counts
twice: the card runs that forward again in the backward.  Tensors are
keyed by their storage (an identity unique for the whole trace) and the
number of writes to it the trace has seen, so that in-place chains join.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops, work
from repro_torch.kernels.wkv6 import CHUNK, kept_stride

__all__ = ["ByteCounter", "kernel_regions"]

aten = torch.ops.aten

EW, RED, OP, KERNEL = range(4)

# ops that keep their input's storage (views aside) or only look at it
_FREE = {aten.detach, aten.alias, aten._unsafe_view, aten.lift_fresh}
# elementwise beyond the ``pointwise`` tag: each output element a function
# of a fixed set of input elements, or of none
_ELEMENTWISE = {
    aten._to_copy, aten.copy_, aten.lift_fresh_copy, aten.cat, aten.stack,
    aten.constant_pad_nd, aten.slice_backward, aten.select_backward,
    aten.flip, aten.tril, aten.triu, aten.floor_divide, aten.repeat,
    aten.zeros, aten.ones, aten.full, aten.empty, aten.empty_strided,
    aten.zeros_like, aten.ones_like, aten.full_like, aten.empty_like,
    aten.new_zeros, aten.new_ones, aten.new_full, aten.new_empty,
    aten.new_empty_strided, aten.scalar_tensor, aten.arange, aten.eye,
    aten.fill_, aten.zero_}
# the tensor argument only gives the result's shape and dtype
_SHAPE_ONLY = {aten.zeros_like, aten.ones_like, aten.full_like,
               aten.empty_like, aten.new_zeros, aten.new_ones, aten.new_full,
               aten.new_empty, aten.new_empty_strided}
# the written argument is overwritten whole, not read
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_}
_SOFTMAX = {aten._softmax, aten._log_softmax, aten._softmax_backward_data,
            aten._log_softmax_backward_data}
# in-place updates that add into the elements they touch
_ACCUMULATE = {aten.index_add_, aten.scatter_add_, aten.scatter_reduce_}


def _accumulates(func, args, kwargs) -> bool:
    """Whether an in-place update adds into the elements it touches."""
    if func.overloadpacket is aten.index_put_:
        return bool(kwargs.get("accumulate", len(args) > 3 and args[3]))
    return func.overloadpacket in _ACCUMULATE


def _kind(func) -> int:
    if torch.Tag.pointwise in func.tags or func.overloadpacket in _ELEMENTWISE:
        return EW
    if torch.Tag.reduction in func.tags or func.overloadpacket in _SOFTMAX:
        return RED
    return OP


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _geometry(t) -> tuple:
    return (t.storage_offset(), tuple(t.shape), tuple(t.stride()), t.dtype)


def _written(func, args, kwargs) -> list[tuple[torch.Tensor, bool]]:
    """[(tensor, also read)] of the arguments ``func`` writes in place: an
    ``out=`` argument and an overwritten one are not read."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        t = args[i] if i < len(args) else kwargs.get(a.name)
        if isinstance(t, torch.Tensor):
            out.append((t, not (a.kwarg_only
                                or func.overloadpacket in _OVERWRITE)))
    return out


class _Node:
    __slots__ = ("kind", "pass_", "rerun", "reads", "scalars", "writes",
                 "fixed")

    def __init__(self, kind, pass_, rerun):
        # pass_: (the counter's pass, the autograd node whose backward
        # formula runs the op, or -1 outside the backward)
        self.kind, self.pass_, self.rerun = kind, pass_, rerun
        self.reads: dict = {}     # key -> {geometry: bytes}
        self.scalars: set = set()  # keys read as one-element tensors
        self.writes: dict = {}    # key -> bytes
        self.fixed = 0


class ByteCounter(TorchDispatchMode):
    """Bytes a trace moves per fused region (see the module docstring):
    ``bytes`` once the trace is done; ``largest``, the largest tensor an op
    made (views, ``detach`` and ``alias`` aside), as the trace runs."""

    def __init__(self):
        super().__init__()
        self.largest = 0
        self._ids: dict = {}        # storage _cdata -> (uid, weakref)
        self._size: list = []       # uid -> the storage's bytes
        self._writes: list = []     # uid -> writes seen
        self._born: set = set()     # uids the trace made
        self._nodes: list = []
        self._producer: dict = {}   # key -> node index
        self._kept: set = set()
        self._hidden = 0
        self._pass = 0
        self._scopes: dict = {}     # autograd node -> its number
        self._rerun = None
        self._reruns = 0
        self._total = None

    # ------------------------------------------------------- recording --
    def _uid(self, t) -> int:
        s = t.untyped_storage()
        got = self._ids.get(s._cdata)
        if got is not None and got[1]() is s:
            return got[0]
        uid = len(self._size)
        self._ids[s._cdata] = (uid, weakref.ref(s))
        self._size.append(s.nbytes())
        self._writes.append(0)
        return uid

    def key(self, t) -> tuple[int, int]:
        """(storage, writes to it so far): one version of one tensor."""
        uid = self._uid(t)
        return uid, self._writes[uid]

    def keep(self, *tensors) -> None:
        """Mark these tensors (their current versions) as escaping: saved
        for the backward, or outliving the trace."""
        for t in _tensors(tensors):
            self._kept.add(self.key(t))

    def next_pass(self) -> None:
        """Ops after this call join no region with ops before it."""
        self._pass += 1

    @contextlib.contextmanager
    def hidden(self):
        """Ops inside run uncounted (a kernel op's plain version)."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    @contextlib.contextmanager
    def rerun(self):
        """Ops inside are a checkpointed layer's forward, which the card
        runs again in the backward."""
        prev, self._rerun = self._rerun, self._reruns
        self._reruns += 1
        try:
            yield
        finally:
            self._rerun = prev

    def _where(self) -> tuple[int, int]:
        """The pass an op runs in: the counter's, and in the backward the
        autograd node whose formula runs it (held, so no number is
        reused)."""
        fn = torch._C._current_autograd_node()
        if fn is None:
            return self._pass, -1
        return self._pass, self._scopes.setdefault(fn, len(self._scopes))

    def _add(self, node, reads, writes) -> None:
        """Record ``node``, reading [(tensor, key)] and writing
        [(tensor, bytes)] (keys taken now)."""
        idx = len(self._nodes)
        for t, k in reads:
            node.reads.setdefault(k, {})[_geometry(t)] = _nbytes(t)
            if t.numel() == 1:
                node.scalars.add(k)
        for t, nb in writes:
            k = self.key(t)
            node.writes[k] = nb
            self._producer[k] = idx
        self._nodes.append(node)
        self._total = None

    def kernel(self, inputs, outputs, nbytes: int) -> None:
        """A kernel's region: reads ``inputs``, makes ``outputs``, moves
        ``nbytes`` (its work function's count)."""
        node = _Node(KERNEL, self._where(), self._rerun)
        node.fixed = nbytes
        outs = _tensors(outputs)
        for t in outs:
            self._born.add(self._uid(t))
        self._add(node, [(t, self.key(t)) for t in _tensors(inputs)],
                  [(t, _nbytes(t)) for t in outs])

    def _note_largest(self, func, out) -> None:
        if not (func.is_view or func.overloadpacket in (aten.detach,
                                                        aten.alias)):
            outs = _tensors(out)
            if outs:
                self.largest = max(self.largest, *map(_nbytes, outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._hidden or func.is_view or func.overloadpacket in _FREE:
            out = func(*args, **kwargs)
            self._note_largest(func, out)
            return out
        kind = _kind(func)
        written = _written(func, args, kwargs)
        skip = {id(t) for t, read in written if not read}
        if func.overloadpacket in _SHAPE_ONLY:
            skip.add(id(args[0]))
        ins = _tensors((args, kwargs))
        reads = [(t, self.key(t)) for t in ins if id(t) not in skip]
        out = func(*args, **kwargs)
        self._note_largest(func, out)
        if not written and not _tensors(out):
            return out
        node = _Node(kind, self._where(), self._rerun)
        writes = []
        for t, read in written:
            uid = self._uid(t)
            self._writes[uid] += 1
            nb = _nbytes(t)
            if kind == OP:   # a scatter: as many elements as its update
                others = [x.numel() for x in ins if x is not t]
                nb = min(nb, max(others, default=0) * t.element_size())
                reads = [r for r in reads if r[0] is not t]
                if _accumulates(func, args, kwargs):
                    node.fixed += nb
            writes.append((t, nb))
        mine = {self._uid(t) for t, _ in written} | {k[0] for _, k in reads}
        for t in _tensors(out):
            uid = self._uid(t)
            if uid not in mine:           # a fresh result
                self._born.add(uid)
                writes.append((t, _nbytes(t)))
        self._add(node, reads, writes)
        return out

    # -------------------------------------------------------- counting --
    @property
    def bytes(self) -> int:
        if self._total is None:
            self._total = self._count()
        return self._total

    def _count(self) -> int:
        nodes, producer = self._nodes, self._producer
        escape = set(self._kept)
        for uid, n in enumerate(self._writes):
            if n and uid not in self._born:   # an input written in place
                escape.add((uid, n))
        region, direct = self._regions(nodes, producer)
        eff = [self._reads(i, region, direct, escape)
               for i in range(len(nodes))]
        readers: dict = {}
        for i, reads in enumerate(eff):
            for k in reads:
                readers.setdefault(k, []).append(i)
        live = [False] * len(nodes)
        for i in range(len(nodes) - 1, -1, -1):
            live[i] = any(k in escape or any(live[r] for r in readers.get(
                k, ())) for k in nodes[i].writes)
        members: dict = {}
        for i, r in enumerate(region):
            if live[i]:
                members.setdefault(r, []).append(i)
        total = 0
        for r, idx in members.items():
            inside = set(idx)
            reads: dict = {}
            nb = 0
            for i in idx:
                v = nodes[i]
                nb += v.fixed
                if v.kind == KERNEL:
                    continue
                for k, g in eff[i].items():
                    if producer.get(k) not in inside:
                        reads.setdefault(k, {}).update(g)
                for k, w in v.writes.items():
                    if k in escape or any(live[j] and region[j] != r
                                          for j in readers.get(k, ())):
                        nb += w
            nb += sum(min(self._size[k[0]], sum(g.values()))
                      for k, g in reads.items())
            reruns = {nodes[i].rerun for i in idx}
            total += nb * (2 if len(reruns) == 1 and None not in reruns
                           else 1)
        return total

    def _reads(self, i, region, direct, escape) -> dict:
        """{key: {geometry: bytes}} node ``i`` reads once producers are
        recomputed where XLA would recompute them: for an elementwise op
        or a reduction, an elementwise producer of the same pass in another
        region is read through (its own inputs read in its place) when it
        reads no more bytes than it writes (a widening cast, a constant),
        and a reduction reads through the elementwise chain whose
        intermediates nothing else outside that chain's region reads."""
        nodes, producer = self._nodes, self._producer
        v = nodes[i]
        if v.kind not in (EW, RED):
            return v.reads
        out: dict = {}
        seen = set()
        stack = list(v.reads.items())
        while stack:
            k, g = stack.pop()
            p = producer.get(k)
            through = False
            if p is not None and p != i and nodes[p].kind == EW and \
                    nodes[p].pass_ == v.pass_ and region[p] != region[i]:
                src = nodes[p]
                cheap = len(src.writes) == 1 and sum(
                    min(self._size[k2[0]], sum(g2.values()))
                    for k2, g2 in src.reads.items()) <= sum(
                        src.writes.values())
                inner = v.kind == RED and k not in escape and all(
                    nodes[j].kind == RED or region[j] == region[p]
                    for j in direct.get(k, ()))
                through = cheap or inner
            if not through:
                out.setdefault(k, {}).update(g)
            elif k not in seen:
                seen.add(k)
                stack.extend(nodes[p].reads.items())
        return out

    @staticmethod
    def _regions(nodes, producer) -> tuple[list[int], dict]:
        """(each node's region, {key: the nodes that read it}).  A node's
        level is the most non-elementwise ops on a path to it (paths
        through a one-element tensor aside: a broadcast scalar such as a
        clip scale holds no kernel back); elementwise ops of one pass and
        one level join through each intermediate that no op other than an
        elementwise op or a reduction reads.  No path but through a
        one-element tensor leaves a region through a non-elementwise op
        and comes back, and the grouping is the same for every layer,
        whatever the depth."""
        direct: dict = {}
        for i, v in enumerate(nodes):
            for k in v.reads:
                direct.setdefault(k, []).append(i)
        blocked = {k for k, rs in direct.items()
                   if any(nodes[j].kind in (OP, KERNEL) for j in rs)}
        level = [0] * len(nodes)
        parent = list(range(len(nodes)))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for c, v in enumerate(nodes):
            for k in v.reads:
                p = producer.get(k)
                if p is not None and p != c and k not in v.scalars:
                    level[c] = max(level[c], level[p]
                                   + (nodes[p].kind != EW))
            if v.kind != EW:
                continue
            for k in v.reads:
                p = producer.get(k)
                if p is not None and p != c and nodes[p].kind == EW and \
                        nodes[p].pass_ == v.pass_ and level[p] == level[c] \
                        and k not in blocked:
                    parent[find(c)] = find(p)
        return [find(i) for i in range(len(nodes))], direct


# ------------------------------------------------------ kernel regions --
def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in args)


def _states(name: str, args):
    """A stand-in (no data) for the float32 states a scan's forward keeps
    for its backward: [B, H, n / stride, rows, state width] (`ops._kept`;
    WKV6's state dk x dk, SSD's hd x ds)."""
    b, s, h, rows = args[0].shape
    width = rows if name == "wkv6" else args[1].shape[-1]
    n = -(-s // CHUNK)
    return torch.empty((b, h, n // kept_stride(n), rows, width),
                       device="meta")


def _forward_bytes(name: str, args, kw, saves: bool) -> int:
    """The kernel's own bytes for one forward call; with ``saves`` (under
    grad) also what it keeps for its backward kernel: the attention's row
    LSE, a scan's kept states."""
    if name == "flash_attention":
        b, sq, h, _ = args[0].shape
        return work.flash_work(*args, **kw)[0] + (4 * b * h * sq if saves
                                                  else 0)
    if name == "decode_attention":
        return work.decode_work(*args)[0]
    count = work.wkv6_work if name == "wkv6" else work.ssd_work
    return count(*args)[0] + (4 * _states(name, args).numel() if saves
                              else 0)


def _backward_bytes(name: str, args, kw, outs, grads, needs) -> int:
    """The backward kernel's own bytes for the gradients ``grads`` of
    ``outs``; ``needs`` the forward inputs that want one (the last, a
    scan's s0)."""
    if name == "flash_attention":
        b, sq, h, _ = args[0].shape
        lse = torch.empty((b, h, sq), device="meta")
        return work.bwd_work(*args, outs[0], grads[0], lse, **kw)[0]
    count = work.wkv6_bwd_work if name == "wkv6" else work.ssd_bwd_work
    return count(*args[:-1], _states(name, args), grads[0], grads[1],
                 want_ds0=needs[-1])[0]


class _Region(torch.autograd.Function):
    """A kernel op's plain version under grad, counted as its kernels: the
    forward runs it as a graph of its own and counts the forward kernel's
    bytes; the backward takes that graph's gradient and counts the
    backward kernel's.  So neither pass counts the plain version's ops,
    and the forward runs once."""

    @staticmethod
    def forward(ctx, counter, name, fn, kw, *args):
        leaves = [a.detach().requires_grad_() if isinstance(a, torch.Tensor)
                  and a.requires_grad else a for a in args]
        with torch.enable_grad(), counter.hidden():
            out = fn(*leaves, **kw)
            nbytes = _forward_bytes(name, args, kw, saves=True)
        outs = out if isinstance(out, tuple) else (out,)
        counter.kernel(args, outs, nbytes)
        ctx.set_materialize_grads(False)
        ctx.graph = (counter, name, kw, args, leaves, outs)
        res = tuple(o.detach() for o in outs)
        return res if isinstance(out, tuple) else res[0]

    @staticmethod
    def backward(ctx, *grads):
        counter, name, kw, args, leaves, outs = ctx.graph
        needs = ctx.needs_input_grad[4:]
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t, need in zip(leaves, needs) if need]
        with counter.hidden():
            got = torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True) if pairs and wanted else ()
            nbytes = _backward_bytes(name, args, kw, outs, grads, needs)
        counter.kernel([*args, *outs, *grads], got, nbytes)
        got = iter(got)
        return (None, None, None, None,
                *(next(got, None) if need else None for need in needs))


def kernel_regions(counter: ByteCounter):
    """`ops.kernel_probe` for a trace under ``counter``: each kernel op
    counts its kernel's bytes in place of its plain version's ops (under
    grad through `_Region`)."""
    def probe(name, fn, args, kw):
        if _needs_grad(args):
            return _Region.apply(counter, name, fn, kw, *args)
        with counter.hidden():
            out = fn(*args, **kw)
            nbytes = _forward_bytes(name, args, kw, saves=False)
        counter.kernel(args, out, nbytes)
        return out
    return ops.kernel_probe(probe)

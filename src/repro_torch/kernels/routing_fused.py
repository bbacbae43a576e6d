"""Phase 1 of the fused routing step as one pass over the (request, agent) grid.

For every pair of the padded (nb, mb) grid of a batch: the Eq.-4 affinity
from the gathered LCP (with the recurrent agents' extension-only rule), the
LRU keep mask and the parent credit (the max over the parent-candidate rows
of the request), the 10 Eq.-5 features, three stacked-forest descents
(latency, cost, quality), the cold-start prior blend with the optimism
bonus, the Eq.-1 value and the pruned, masked welfare weight W; and wmax,
the largest W over agents with units, which anchors the auction's ε
schedule.  It transcribes the reference's fused program
(`src/repro/core/routing_fused.py:212-308`) in float32, op for op.

On the card this is ``fused_phase1_kernel`` (``csrc/routing_fused.cu``, one
thread per pair); ``fused_phase1_plain`` is the same pass in plain PyTorch
float32 ops, used for CPU tensors and as the kernel's oracle.  The two are
bit-identical.  Both write into one packed float32 buffer whose layout is
``packed_layout``: a header (wmax, then the auction's rounds, trip flag and
ε_final, which the fused mode of ``auction_solve`` writes), lat, cst, qual,
values, X, the auction's unit prices, agent_of and unit_of, and at the end
W, which stays on the device.  The router copies the buffer up to W to the
host in one copy.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

__all__ = ["Forest", "Phase1Args", "PackedLayout", "packed_layout",
           "fused_phase1_cuda", "fused_phase1_plain", "N_FEATURES",
           "BLEND_ROWS"]

N_FEATURES = 10
# per-agent rows of the blend block: prior latency per token, prior latency
# base, the three token prices, the generation-length EWMA, n_obs, warm_n,
# prior quality, reputation, the optimism knob
BLEND_ROWS = 11
HEADER = 8      # wmax, rounds, tripped, eps_final, 4 spare words


@dataclass(frozen=True)
class PackedLayout:
    """Word offsets of the packed output of one (nb, mb, cbu) shape."""

    nb: int
    mb: int
    cbu: int

    @property
    def pairs(self) -> int:
        return self.nb * self.mb

    @property
    def lat(self) -> int:
        return HEADER

    @property
    def cst(self) -> int:
        return self.lat + self.pairs

    @property
    def qual(self) -> int:
        return self.cst + self.pairs

    @property
    def values(self) -> int:
        return self.qual + self.pairs

    @property
    def X(self) -> int:
        return self.values + self.pairs

    @property
    def price(self) -> int:
        return self.X + N_FEATURES * self.pairs

    @property
    def agent_of(self) -> int:
        return self.price + self.mb * self.cbu

    @property
    def unit_of(self) -> int:
        return self.agent_of + self.nb

    @property
    def host(self) -> int:
        """Words the host copies: everything before W."""
        return self.unit_of + self.nb

    @property
    def W(self) -> int:
        return self.host

    @property
    def total(self) -> int:
        return self.W + self.pairs


def packed_layout(nb: int, mb: int, cbu: int) -> PackedLayout:
    """The packed output's layout for a padded (nb, mb) grid with ``cbu``
    unit columns per agent."""
    return PackedLayout(nb, mb, cbu)


@dataclass
class Forest:
    """One target's stacked forest on a device: node arrays padded to a pow-2
    pool (padded nodes are leaves: ``feature`` -1), each padded agent's root
    (padded agents root at tree 0) and the bucketed walk depth."""

    feature: torch.Tensor     # int32 [kb]
    left: torch.Tensor        # int32 [kb]
    right: torch.Tensor       # int32 [kb]
    roots: torch.Tensor       # int32 [mb]
    threshold: torch.Tensor   # float32 [kb]
    value: torch.Tensor       # float32 [kb]
    depth: int


@dataclass
class Phase1Args:
    """The inputs of one Phase-1 pass, all on one device.  ``lcp`` and
    ``rows`` stack the nb request rows and then the ``cb`` parent-candidate
    rows (``cb = 0`` when the batch has no parents); ``cj[c]`` is the
    request of candidate c, ``nb`` for padding."""

    lcp: torch.Tensor         # int32 [nb + cb, mb] gathered LCP
    rows: torch.Tensor        # int32 [nb + cb, mb] arena rows
    alen: torch.Tensor        # int32 [S] arena row lengths
    plen: torch.Tensor        # int32 [nb]
    cj: torch.Tensor          # int32 [cb]
    keep: torch.Tensor        # int32 [nb, mb]
    ckeep: torch.Tensor       # int32 [cb, mb]
    ext: torch.Tensor         # int32 [mb]
    req_mask: torch.Tensor    # int32 [nb]
    agent_mask: torch.Tensor  # int32 [mb]
    counts: torch.Tensor      # int32 [mb]
    turns: torch.Tensor       # float32 [nb]
    dom: torch.Tensor         # float32 [nb, mb]
    router: torch.Tensor      # float32 [2]
    inflight: torch.Tensor    # float32 [mb]
    rps: torch.Tensor         # float32 [mb]
    caps: torch.Tensor        # float32 [mb]
    blend: torch.Tensor       # float32 [BLEND_ROWS, mb]
    val_cfg: torch.Tensor     # float32 [3]: delta, latency scale, value scale
    forests: tuple            # (lat, cost, quality) Forest
    nb: int
    mb: int
    cb: int

    def map(self, fn) -> Phase1Args:
        """A copy with ``fn`` applied to every tensor, the forests' too
        (``args.map(torch.clone)``, ``args.map(lambda t: t.cpu())``)."""
        return _map_tensors(self, fn)


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_tensors(o, fn) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


# ------------------------------------------------------------ the kernel --
_P = ctypes.c_void_p
_I = ctypes.c_int32


class _CForest(ctypes.Structure):
    _fields_ = [("feature", _P), ("left", _P), ("right", _P), ("roots", _P),
                ("threshold", _P), ("value", _P), ("depth", _I),
                ("pad_", _I)]


class _CArgs(ctypes.Structure):
    _fields_ = ([(n, _P) for n in (
        "lcp", "rows", "alen", "plen", "cj", "keep", "ckeep", "ext",
        "req_mask", "agent_mask", "counts", "turns", "dom", "router",
        "inflight", "rps", "caps", "blend", "val_cfg")]
        + [("forest", _CForest * 3)]
        + [(n, _P) for n in ("wmax", "lat", "cst", "qual", "values", "X",
                             "W")]
        + [("nb", _I), ("mb", _I), ("cb", _I)])


def _lib() -> ctypes.CDLL:
    lib = build.load("routing_fused")
    lib.fused_phase1_launch.argtypes = [ctypes.POINTER(_CArgs), _P]
    lib.fused_phase1_launch.restype = ctypes.c_int
    lib.fused_phase1_args_size.restype = ctypes.c_int
    if lib.fused_phase1_args_size() != ctypes.sizeof(_CArgs):
        raise RuntimeError("the Phase1Args layout of csrc/routing_fused.cu "
                           "differs from kernels/routing_fused.py")
    return lib


_INT_FIELDS = ("lcp", "rows", "alen", "plen", "cj", "keep", "ckeep", "ext",
               "req_mask", "agent_mask", "counts")
_FLOAT_FIELDS = ("turns", "dom", "router", "inflight", "rps", "caps",
                 "blend", "val_cfg")


def _check(a: Phase1Args, out: torch.Tensor, lay: PackedLayout) -> None:
    dev = out.device
    tensors = [getattr(a, f) for f in _INT_FIELDS + _FLOAT_FIELDS]
    for fo in a.forests:
        tensors += [fo.feature, fo.left, fo.right, fo.roots, fo.threshold,
                    fo.value]
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_phase1 takes its inputs and output on one "
                         "device")
    if any(getattr(a, f).dtype != torch.int32 for f in _INT_FIELDS) or any(
            getattr(a, f).dtype != torch.float32 for f in _FLOAT_FIELDS) \
            or out.dtype != torch.float32:
        raise TypeError("fused_phase1 takes int32 indices and masks, float32 "
                        "features and a float32 output")
    if not all(t.is_contiguous() for t in tensors + [out]):
        raise ValueError("fused_phase1 takes contiguous tensors")
    if (lay.nb, lay.mb) != (a.nb, a.mb) or out.numel() != lay.total:
        raise ValueError("the output does not have the batch's layout")
    if tuple(a.lcp.shape) != (a.nb + a.cb, a.mb) \
            or a.rows.shape != a.lcp.shape or a.cj.numel() < a.cb \
            or a.blend.shape != (BLEND_ROWS, a.mb) or len(a.forests) != 3:
        raise ValueError("fused_phase1 inputs do not match (nb, mb, cb)")


def fused_phase1_cuda(a: Phase1Args, out: torch.Tensor,
                      lay: PackedLayout) -> torch.Tensor:
    """One launch of ``fused_phase1_kernel`` over ``a`` (contiguous CUDA
    tensors on one device) into ``out`` (float32 [lay.total]) on the current
    stream; returns ``out``.  Raises on any other input and on a failed
    launch."""
    if out.device.type != "cuda":
        raise ValueError("fused_phase1_cuda takes CUDA tensors")
    _check(a, out, lay)
    ptr = out.data_ptr()
    c = _CArgs()
    for f in _INT_FIELDS + _FLOAT_FIELDS:
        setattr(c, f, getattr(a, f).data_ptr())
    for k, fo in enumerate(a.forests):
        c.forest[k] = _CForest(fo.feature.data_ptr(), fo.left.data_ptr(),
                               fo.right.data_ptr(), fo.roots.data_ptr(),
                               fo.threshold.data_ptr(), fo.value.data_ptr(),
                               int(fo.depth), 0)
    for f in ("lat", "cst", "qual", "values", "X", "W"):
        setattr(c, f, ptr + 4 * getattr(lay, f))
    c.wmax = ptr
    c.nb, c.mb, c.cb = a.nb, a.mb, a.cb
    err = _lib().fused_phase1_launch(
        ctypes.byref(c), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_phase1 kernel launch failed: CUDA error "
                           f"{err}")
    return out


# ------------------------------------------------------- the plain version --
def _affinity(raw, llen, plen, ext):
    """Eq.-4 scores from raw LCPs (the reference's ``lcp_scores``)."""
    lcp = torch.minimum(raw, torch.minimum(plen, llen))
    pl1 = plen.clamp(min=1).to(torch.float32)
    sc = lcp.to(torch.float32) / pl1
    full_prev = (lcp == llen) & (llen > 0)
    return torch.where(ext, torch.where(full_prev,
                                        llen.to(torch.float32) / pl1, 0.0),
                       sc)


def _descend(fo: Forest, flat, col):
    from repro_torch.core.hoeffding import descend_nodes

    cur = descend_nodes(fo.feature, fo.threshold, fo.left, fo.right,
                        fo.roots[col].long(), flat, fo.depth)
    return fo.value[cur]


def fused_phase1_plain(a: Phase1Args, out: torch.Tensor,
                       lay: PackedLayout) -> torch.Tensor:
    """What ``fused_phase1_cuda`` computes, in PyTorch float32 ops on
    ``out``'s device, in the reference program's op order."""
    _check(a, out, lay)
    nb, mb, cb = a.nb, a.mb, a.cb
    ext = a.ext.bool()[None, :]
    rows = a.rows.long()
    llen = a.alen[rows]
    o = torch.where(a.keep.bool(), _affinity(a.lcp[:nb], llen[:nb],
                                             a.plen[:, None], ext[:, :]), 0.0)
    if cb:
        cj = a.cj[:cb].long()
        cplen = a.plen[cj.clamp(0, nb - 1)][:, None]
        cred = torch.where(a.ckeep[:cb].bool(),
                           _affinity(a.lcp[nb:], llen[nb:], cplen, ext), 0.0)
        # scatter-max over each request's candidates; cj == nb is dropped
        # into a sink row
        buf = torch.cat([o, o.new_zeros(1, mb)])
        buf.scatter_reduce_(0, cj[:, None].expand(cb, mb), cred, "amax",
                            include_self=True)
        o = buf[:nb]
    util = a.inflight / a.caps.clamp(min=1.0)

    def bc(v):
        return v.expand(nb, mb)

    X = torch.stack([
        bc(a.plen.to(torch.float32)[:, None]), bc(a.turns[:, None]), o,
        bc(a.router[0]), bc(a.router[1]), bc(a.inflight[None, :]),
        bc(a.rps[None, :]), bc(a.caps[None, :]), bc(util[None, :]), a.dom,
    ], dim=-1)
    flat = X.reshape(nb * mb, N_FEATURES)
    col = torch.arange(nb * mb, device=out.device) % mb
    raw_lat, raw_cst, raw_q = (_descend(fo, flat, col).reshape(nb, mb)
                               for fo in a.forests)
    # the reference's transcription of predictor._blend_with_prior
    (lpt, lb, miss, hit, out_, ewma, n_obs, warm_n, prior_q, rep,
     expl) = a.blend
    pl_, aff, util2 = X[..., 0], X[..., 2], X[..., 8]
    uncached = pl_ * (1.0 - aff)
    prior_lat = (lb + lpt * uncached) * (1.0 + util2)
    npmt = torch.trunc(pl_)
    nhit = aff * npmt
    prior_cst = miss * (npmt - nhit) + hit * nhit + out_ * ewma
    wgt = (n_obs / 60.0).clamp(max=1.0) * rep
    lat = (1.0 - wgt) * prior_lat + wgt * raw_lat.clamp(min=0.0)
    cst = (1.0 - wgt) * prior_cst + wgt * raw_cst.clamp(min=0.0)
    cold = n_obs < warm_n
    lat = torch.where(cold, prior_lat, lat)
    cst = torch.where(cold, prior_cst, cst)
    qual = torch.where(cold, prior_q * rep, raw_q.clamp(0.0, 1.0) * rep)
    qual = torch.where(expl != 0.0,
                       (qual + expl / torch.sqrt(1.0 + n_obs)).clamp(max=1.0),
                       qual)
    # Eq.-1 value -> pruned, masked welfare
    delta, lscale, vscale = a.val_cfg[0], a.val_cfg[1], a.val_cfg[2]
    values = vscale * (delta * qual.clamp(0.0, 1.0)
                       - (1.0 - delta) * lat / lscale)
    W = values - cst
    W = torch.where(W > 0.0, W, 0.0)
    W = torch.where(a.req_mask.bool()[:, None] & a.agent_mask.bool()[None, :],
                    W, 0.0)
    wmax = torch.where(a.counts[None, :] > 0, W, 0.0).max()
    out[0] = wmax
    for name, t in (("lat", lat), ("cst", cst), ("qual", qual),
                    ("values", values), ("W", W)):
        at = getattr(lay, name)
        out[at:at + lay.pairs] = t.reshape(-1)
    out[lay.X:lay.X + N_FEATURES * lay.pairs] = X.reshape(-1)
    return out

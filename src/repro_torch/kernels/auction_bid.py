"""The capacitated column auction of Phase 2: one round, and the whole solve.

``auction_bid`` is one Jacobi forward-bidding round.  For an (n × m)
agent-level weight matrix and the two cheapest unit prices per agent
(``ask``, ``ask2``):

    P[j, i]  = W[j, i] - ask[i]               (only active rows compete)
    v1, k1   = top profit and its agent       (per request, lowest index)
    v2       = runner-up profit with the favourite agent's own ask2
               substituted at k1, floored at the outside option 0
    bid[j]   = ask[k1] + (v1 - v2) + ε        (only if v1 > 0, else park)
    best[i]  = max over bidders with k1 = i of bid[j]   (segment max)
    winner[i]= min j among bidders at best[i]           (deterministic ties)

On the card this is the hand-written kernel in ``csrc/auction_bid.cu`` (one
warp per request row, the segment max as a 64-bit atomicMax on an ordered
key); ``auction_bid_plain`` is the same round in plain PyTorch
(`kernels/ref.py`), used for CPU tensors and as the kernel's oracle.  The
two are bit-identical.

``auction_solve`` is the whole staged ε-scaling solve of many markets (the
hub blocks of a batch): ε phases, eviction, forward bidding and reverse
rounds, each market under its own round cap.  On the card it is one launch
of ``auction_solve_kernel``, one thread block per market, every loop on the
device; ``auction_solve_plain`` runs the solver's host-driven staged market
(`core/solvers/dense_torch.py::_StagedMarket`) per market, for CPU tensors
and as the kernel's oracle.  The two are bit-identical: unit prices,
assignment and round counts.  The markets travel packed (`pack_markets`):
a float32 buffer, an int32 buffer and a host layout table; the result is
one int32 buffer (`unpack_solution`).

``auction_fused`` is the solve's fused mode for the fused routing step
(`core/routing_fused.py`): one market whose W and wmax the fused Phase-1
pass (`kernels/routing_fused.py`) wrote into the step's packed buffer, the
ε schedule derived from wmax in float32 as the reference's fused program
derives it (`src/repro/core/routing_fused.py:308-320`), the warm attempt
under its round budget and, when it trips, the cold re-solve from zero
prices, all in one launch of ``auction_fused_kernel``; the result goes back
into the packed buffer.  ``auction_fused_plain`` runs the same on the
host-driven staged market.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import auction_bid_ref as auction_bid_plain

__all__ = ["auction_bid_cuda", "auction_bid_plain", "auction_fused_cuda",
           "auction_fused_plain", "auction_solve_cuda", "auction_solve_plain",
           "auction_solve_plan", "pack_markets", "unpack_solution"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# one market's row of the layout table: n, m, cmax, its round cap, the
# offsets of W and of the start grid in the float buffer, of the counts in
# the int buffer, and of its grid and its requests in the output
META = ("n", "m", "cmax", "cap", "w_off", "p_off", "c_off", "g_off", "r_off")


class _FusedArgs(ctypes.Structure):
    _fields_ = ([(n, _P) for n in ("W", "counts", "p0", "hdr", "price",
                                   "agent_of", "unit_of")]
                + [("theta", ctypes.c_float)]
                + [(n, ctypes.c_int32) for n in ("n", "m", "cmax", "budget",
                                                 "max_rounds", "warm")])


def _lib() -> ctypes.CDLL:
    lib = build.load("auction_bid")
    fn = lib.auction_bid_launch
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    fn = lib.auction_solve_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    fn = lib.auction_solve_plan
    fn.argtypes = [_I, _I, _I, _I * 2]
    fn.restype = _I
    lib.auction_fused_launch.argtypes = [ctypes.POINTER(_FusedArgs), _P]
    lib.auction_fused_launch.restype = _I
    lib.auction_fused_args_size.restype = _I
    if lib.auction_fused_args_size() != ctypes.sizeof(_FusedArgs):
        raise RuntimeError("the FusedSolveArgs layout of csrc/auction_bid.cu "
                           "differs from kernels/auction_bid.py")
    return lib


def auction_bid_cuda(W: torch.Tensor, ask: torch.Tensor, ask2: torch.Tensor,
                     active: torch.Tensor, eps):
    """W [n, m] float32, ask/ask2 [m] float32, active [n] bool (contiguous
    CUDA tensors on one device), eps a float32 scalar -> (best [m] float32,
    winner [m] int32, wants [n] bool), launched on the current stream.
    Raises on any other input and on a failed launch."""
    dev = W.device
    if dev.type != "cuda" or any(t.device != dev for t in (ask, ask2, active)):
        raise ValueError("auction_bid_cuda takes CUDA tensors on one device")
    if W.dtype != torch.float32 or ask.dtype != torch.float32 \
            or ask2.dtype != torch.float32 or active.dtype != torch.bool:
        raise TypeError("auction_bid_cuda takes float32 W/ask/ask2 and a "
                        "bool active mask")
    if W.dim() != 2 or W.shape[1] == 0:
        raise ValueError(f"W must be [n, m] with m > 0, got {tuple(W.shape)}")
    n, m = W.shape
    if ask.shape != (m,) or ask2.shape != (m,) or active.shape != (n,):
        raise ValueError("ask/ask2 must be [m] and active [n]")
    if not all(t.is_contiguous() for t in (W, ask, ask2, active)):
        raise ValueError("auction_bid_cuda takes contiguous tensors")
    eps32 = np.float32(eps)
    if eps32 != eps:
        raise ValueError(f"eps {eps!r} is not a float32 value")
    best = torch.empty((m,), dtype=torch.float32, device=dev)
    winner = torch.empty((m,), dtype=torch.int32, device=dev)
    wants = torch.empty((n,), dtype=torch.bool, device=dev)
    keys = torch.empty((m,), dtype=torch.int64, device=dev)   # scratch
    err = _lib().auction_bid_launch(
        W.data_ptr(), ask.data_ptr(), ask2.data_ptr(), active.data_ptr(),
        float(eps32), best.data_ptr(), winner.data_ptr(), wants.data_ptr(),
        keys.data_ptr(), n, m, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"auction_bid kernel launch failed: CUDA error "
                           f"{err}")
    return best, winner, wants


def pack_markets(markets):
    """Pack markets for one ``auction_solve`` call.

    ``markets``: (W [n, m], counts [m], p0 [m, cmax], eps0, eps_final,
    theta, cap) per market, NumPy arrays and numbers on the host; the three
    ε values are rounded to float32 here.  Returns (fbuf float32, ibuf
    int32, meta int32 [G, 9]): fbuf holds (eps0, eps_final, theta) per
    market and then every W and p0, ibuf the layout table (``META`` per
    market) and then every counts vector, and meta is the layout table on
    the host."""
    G = len(markets)
    meta = np.zeros((G, len(META)), np.int32)
    scal = np.zeros((G, 3), np.float32)
    f_at, i_at, g_at, r_at = 3 * G, len(META) * G, 0, 0
    for g, (W, counts, p0, eps0, eps_final, theta, cap) in enumerate(markets):
        n, m = W.shape
        cmax = p0.shape[1]
        meta[g] = (n, m, cmax, cap, f_at, f_at + n * m, i_at, g_at, r_at)
        scal[g] = (eps0, eps_final, theta)
        f_at += n * m + m * cmax
        i_at += m
        g_at += m * cmax
        r_at += n
    fbuf = np.empty(f_at, np.float32)
    ibuf = np.empty(i_at, np.int32)
    fbuf[:3 * G] = scal.ravel()
    ibuf[:meta.size] = meta.ravel()
    for (W, counts, p0, *_), (n, m, cmax, _c, w_off, p_off, c_off, _g, _r) \
            in zip(markets, meta):
        fbuf[w_off:w_off + n * m] = np.asarray(W, np.float32).ravel()
        fbuf[p_off:p_off + m * cmax] = np.asarray(p0, np.float32).ravel()
        ibuf[c_off:c_off + m] = counts
    return fbuf, ibuf, meta


def _sizes(meta):
    """(Σ m·cmax, Σ n): the output's grid and request lengths."""
    return (int((meta[:, 1] * meta[:, 2]).sum()), int(meta[:, 0].sum()))


def _bounds(meta):
    """(max n, max m, max cmax): what every block's layout fits in."""
    return tuple(int(meta[:, k].max()) for k in range(3))


def unpack_solution(out: np.ndarray, meta: np.ndarray):
    """The host copy of an ``auction_solve`` result -> (unit_price [m, cmax]
    float32, agent_of [n] int32, unit_of [n] int32, rounds) per market."""
    G = len(meta)
    total_grid, total_req = _sizes(meta)
    rounds = out[:G]
    grids = out[G:G + total_grid].view(np.float32)
    agents = out[G + total_grid:G + total_grid + total_req]
    units = out[G + total_grid + total_req:]
    res = []
    for g, (n, m, cmax, _c, _w, _p, _i, g_off, r_off) in enumerate(meta):
        res.append((grids[g_off:g_off + m * cmax].reshape(m, cmax),
                    agents[r_off:r_off + n], units[r_off:r_off + n],
                    int(rounds[g])))
    return res


def auction_solve_cuda(fbuf: torch.Tensor, ibuf: torch.Tensor,
                       meta: np.ndarray) -> torch.Tensor:
    """fbuf float32 / ibuf int32 (contiguous CUDA tensors on one device,
    packed by `pack_markets`), meta the host layout table -> the packed
    int32 result on the device (`unpack_solution` reads its host copy),
    launched on the current stream.  Raises on any other input and on a
    failed launch."""
    dev = fbuf.device
    if dev.type != "cuda" or ibuf.device != dev:
        raise ValueError("auction_solve_cuda takes CUDA tensors on one "
                         "device")
    if fbuf.dtype != torch.float32 or ibuf.dtype != torch.int32:
        raise TypeError("auction_solve_cuda takes a float32 and an int32 "
                        "buffer")
    if not (fbuf.is_contiguous() and ibuf.is_contiguous()):
        raise ValueError("auction_solve_cuda takes contiguous buffers")
    meta = np.asarray(meta, np.int32)
    if meta.ndim != 2 or meta.shape[1] != len(META) or len(meta) == 0:
        raise ValueError(f"meta must be [G > 0, {len(META)}]")
    total_grid, total_req = _sizes(meta)
    G = len(meta)
    out = torch.empty(G + total_grid + 2 * total_req, dtype=torch.int32,
                      device=dev)
    err = _lib().auction_solve_launch(
        fbuf.data_ptr(), ibuf.data_ptr(), out.data_ptr(), G,
        *_bounds(meta), total_grid, total_req,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"auction_solve kernel launch failed: CUDA error "
                           f"{err}")
    return out


def auction_solve_plan(meta: np.ndarray) -> tuple[bool, int]:
    """How ``auction_solve_cuda`` launches over the markets of ``meta``:
    whether W sits in shared memory, and the dynamic shared memory of each
    block in bytes (on the current CUDA device)."""
    info = (_I * 2)()
    err = _lib().auction_solve_plan(*_bounds(np.asarray(meta)), info)
    if err != 0:
        raise RuntimeError(f"no auction_solve launch fits: CUDA error {err}")
    return bool(info[0]), int(info[1])


def auction_solve_plain(fbuf: torch.Tensor, ibuf: torch.Tensor,
                        meta: np.ndarray) -> torch.Tensor:
    """What ``auction_solve_cuda`` computes, market by market through the
    solver's host-driven staged market, on the buffers' device."""
    # the plain version is the solver's own staged market
    from repro_torch.core.solvers.dense_torch import _StagedMarket

    meta = np.asarray(meta, np.int32)
    G = len(meta)
    total_grid, total_req = _sizes(meta)
    out = torch.empty(G + total_grid + 2 * total_req, dtype=torch.int32,
                      device=fbuf.device)
    grids = out[G:G + total_grid].view(torch.float32)
    agents = out[G + total_grid:G + total_grid + total_req]
    units = out[G + total_grid + total_req:]
    for g, (n, m, cmax, cap, w_off, p_off, c_off, g_off, r_off) in \
            enumerate(meta.tolist()):
        eps0, eps_final, theta = fbuf[3 * g:3 * g + 3].tolist()
        market = _StagedMarket(fbuf[w_off:w_off + n * m].view(n, m),
                               ibuf[c_off:c_off + m], cmax, cap, eps_final)
        price, agent_of, unit_of, rounds = market.solve(
            fbuf[p_off:p_off + m * cmax].view(m, cmax), eps0, eps_final,
            theta)
        grids[g_off:g_off + m * cmax] = price.reshape(-1)
        agents[r_off:r_off + n] = agent_of
        units[r_off:r_off + n] = unit_of
        out[g] = rounds
    return out


def _check_fused(out, counts, p0, lay) -> None:
    if counts.device != out.device or p0.device != out.device:
        raise ValueError("auction_fused takes tensors on one device")
    if out.dtype != torch.float32 or p0.dtype != torch.float32 \
            or counts.dtype != torch.int32:
        raise TypeError("auction_fused takes a float32 packed buffer and "
                        "start grid and int32 counts")
    if not all(t.is_contiguous() for t in (out, counts, p0)):
        raise ValueError("auction_fused takes contiguous tensors")
    if out.numel() != lay.total or counts.numel() != lay.mb \
            or p0.numel() != lay.mb * lay.cbu:
        raise ValueError("auction_fused inputs do not match the layout")


def auction_fused_cuda(out: torch.Tensor, counts: torch.Tensor,
                       p0: torch.Tensor, lay, *, budget: int,
                       max_rounds: int, warm: bool,
                       theta: float) -> torch.Tensor:
    """The fused-mode solve on the card: the (lay.nb, lay.mb) market whose
    W and wmax sit in the packed buffer ``out`` (float32, layout ``lay`` of
    `kernels/routing_fused.packed_layout`), ``counts`` int32 [mb] units per
    agent, ``p0`` float32 [mb, cbu] the warm start grid; writes the unit
    prices, agent_of, unit_of, rounds, the trip flag and ε_final into
    ``out`` in one launch on the current stream and returns it.  Raises on
    any other input and on a failed launch."""
    if out.device.type != "cuda":
        raise ValueError("auction_fused_cuda takes CUDA tensors")
    _check_fused(out, counts, p0, lay)
    ptr = out.data_ptr()
    a = _FusedArgs(ptr + 4 * lay.W, counts.data_ptr(), p0.data_ptr(), ptr,
                   ptr + 4 * lay.price, ptr + 4 * lay.agent_of,
                   ptr + 4 * lay.unit_of, float(np.float32(theta)), lay.nb,
                   lay.mb, lay.cbu, int(budget), int(max_rounds), int(warm))
    err = _lib().auction_fused_launch(
        ctypes.byref(a), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"auction_fused kernel launch failed: CUDA error "
                           f"{err}")
    return out


def fused_eps(wmax, p0max, *, warm: bool, theta: float):
    """The fused mode's ε schedule from wmax in float32 scalars (the
    reference's ``jax_eps_final`` and ``warm_eps0`` as traced float32, as
    `routing_fused.py:308-320` computes them): (eps0, eps_final,
    cold_eps0)."""
    f32 = np.float32
    wmax, theta = f32(wmax), f32(theta)
    anchor = max(wmax, f32(1.0))
    eps_final = max(f32(1e-5) * anchor,
                    f32(64.0 * np.finfo(np.float32).eps) * anchor)
    cold_eps0 = max(wmax / theta, eps_final)
    eps0 = cold_eps0
    if warm:
        fine = max(wmax / (theta * theta * theta), eps_final)
        if f32(p0max) > fine:
            eps0 = fine
    return eps0, eps_final, cold_eps0


def auction_fused_plain(out: torch.Tensor, counts: torch.Tensor,
                        p0: torch.Tensor, lay, *, budget: int,
                        max_rounds: int, warm: bool,
                        theta: float) -> torch.Tensor:
    """What ``auction_fused_cuda`` computes, through the solver's
    host-driven staged market on the buffers' device, with the same ε
    derivation and cold fallback in float32 scalars."""
    from repro_torch.core.solvers.dense_torch import _StagedMarket

    _check_fused(out, counts, p0, lay)
    nb, mb, cbu = lay.nb, lay.mb, lay.cbu
    W = out[lay.W:lay.W + nb * mb].view(nb, mb)
    grid = p0.view(mb, cbu)
    eps0, eps_final, cold_eps0 = fused_eps(
        out[0].item(), grid.max().item() if grid.numel() else 0.0,
        warm=warm, theta=theta)
    cap = budget if warm else max_rounds
    price, agent_of, unit_of, rounds = _StagedMarket(
        W, counts, cbu, cap, eps_final).solve(grid, eps0, eps_final, theta)
    tripped = bool(warm and rounds >= budget)
    if tripped:
        price, agent_of, unit_of, rounds = _StagedMarket(
            W, counts, cbu, max_rounds, eps_final).solve(
            torch.zeros_like(grid), cold_eps0, eps_final, theta)
    out[lay.price:lay.price + mb * cbu] = price.reshape(-1)
    ints = out.view(torch.int32)
    ints[lay.agent_of:lay.agent_of + nb] = agent_of
    ints[lay.unit_of:lay.unit_of + nb] = unit_of
    ints[1] = rounds
    ints[2] = int(tripped)
    out[3] = float(eps_final)
    return out

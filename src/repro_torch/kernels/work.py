"""The bytes and operations one call of a ported kernel needs: each input
read once, each output written once, and the arithmetic its inputs ask
for (an exp counted as one operation).

Two readers count with these functions: ``chip_smoke.py``, whose bound
column (bytes at the card's memory rate or operations at its peak rate,
the larger) sits beside each kernel's measured time, and the dry run
(`launch/traffic.py`), which counts each kernel op of a traced step as
its kernel's own reads and writes.  Each takes the call's tensors (a
tensor without data, as the dry run's fake tensors, stands for its
shape) and returns ``(bytes, operations)``.
"""
from __future__ import annotations

from repro_torch.kernels.wkv6 import CHUNK

__all__ = ["attended_pairs", "bwd_work", "decode_work", "flash_work",
           "ssd_bwd_work", "ssd_work", "wkv6_bwd_work", "wkv6_work"]


def attended_pairs(sq: int, sk: int, *, causal=True, window=0,
                   q_offset=0) -> int:
    """The (query, key) pairs the masks leave: query row i at key
    position i + q_offset sees key j when j <= i + q_offset (causal) and
    i + q_offset - j < window (a window)."""
    n = 0
    for i in range(sq):
        pos = i + q_offset
        hi = min(sk - 1, pos) if causal else sk - 1
        lo = max(0, pos - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def flash_work(q, k, v, *, causal=True, window=0,
               q_offset=0) -> tuple[int, int]:
    """(bytes, operations) one prefill-attention call needs: q, k and v
    read once and o written once; a multiply-add for QK^T and one for PV
    on every (query, key) pair the masks leave (query i at key position
    i + q_offset)."""
    b, sq, h, d = q.shape
    pairs = b * attended_pairs(sq, k.shape[1], causal=causal, window=window,
                               q_offset=q_offset)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return nbytes, 4 * h * d * pairs


def bwd_work(q, k, v, o, do, lse=None, *, causal=True, window=0,
             q_offset=0) -> tuple[int, int]:
    """(bytes, operations) of one flash backward call: q, o, dO, dQ and
    k, v, dK, dV moved once, and the forward's float32 LSE read once;
    10·H·d operations per unmasked pair (Q·Kᵀ again, dO·Vᵀ, P·dO, dS·K,
    dS·Q)."""
    _, fwd_ops = flash_work(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
    lse_bytes = 0 if lse is None else 4 * lse.numel()
    return (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse_bytes, \
        fwd_ops // 4 * 10


def _true_count(mask) -> int:
    """The True entries of ``mask``; every entry of a tensor without data
    (the dry run's cache, traced full)."""
    from torch._subclasses.fake_tensor import is_fake

    return mask.numel() if is_fake(mask) or mask.is_meta \
        else int(mask.sum())


def decode_work(q, k_cache, v_cache, valid) -> tuple[int, int]:
    """(bytes, operations) one decode-attention call needs: q, the mask,
    the K and V rows of the valid slots only (nothing else decides the
    output), o written once; QK^T and PV multiply-adds per valid slot."""
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    nvalid = _true_count(valid)
    es = q.element_size()
    nbytes = 2 * q.numel() * es + 2 * nvalid * hkv * d * es + valid.numel()
    return nbytes, 4 * h * d * nvalid


def wkv6_work(r, k, v, log_w, u, s0=None) -> tuple[int, int]:
    """(bytes, operations) one WKV6 call needs: r, k, v, log_w, u and the
    initial state (when one is given) read once, o and the final state
    written once; per (batch·head, chunk of 16 tokens): the inter-chunk
    and state-update products (2·16·dk·dv each), the intra-chunk matrix
    over its s < t pairs (a multiply-add and an exp per channel: 4
    operations), its product with v over s <= t, and the decays of r and k
    (an exp and a multiply each), counting an exp as one operation."""
    b, s, h, dk = r.shape
    n = -(-s // CHUNK)
    es = r.element_size()
    state = 4 * b * h * dk * dk
    nbytes = (4 * r.numel() * es + 4 * log_w.numel() + 4 * u.numel()
              + (0 if s0 is None else state) + state)
    c = CHUNK
    per = 4 * c * dk * dk + c * (c + 1) * dk + 2 * c * (c - 1) * dk \
        + 4 * c * dk
    return nbytes, b * h * n * per


def ssd_work(x, bmat, cmat, dt, a_log, d_skip, s0=None) -> tuple[int, int]:
    """(bytes, operations) one SSD call needs: x, B, C (once: the heads
    share them), dt, a_log, D and the initial state (when one is given)
    read once, y and the final state written once; per chunk of 16: C·Bᵀ
    over s <= t once for all heads, and per head the decay-weighted mix
    with x, the inter-chunk C·Sᵀ and the state update (2·16·hd·ds each),
    the exps, the skip."""
    b, s, h, hd = x.shape
    ds = bmat.shape[-1]
    n = -(-s // CHUNK)
    es = x.element_size()
    state = 4 * b * h * hd * ds
    nbytes = (2 * x.numel() * es + 2 * bmat.numel() * es + 4 * dt.numel()
              + 8 * h + (0 if s0 is None else state) + state)
    c = CHUNK
    shared = c * (c + 1) * ds
    per_head = 4 * c * hd * ds + c * (c + 1) * hd + 3 * c * (c + 1) // 2 \
        + 4 * c * hd + 3 * c
    return nbytes, b * n * (shared + h * per_head)


def wkv6_bwd_work(r, k, v, log_w, u, states, do, dst=None,
                  want_ds0=False) -> tuple[int, int]:
    """(bytes, operations) one WKV6 backward call needs: r, k, v, dO,
    log_w, u, the kept states (every chunk's, or every 16th's) and dsT
    (when given) read once, dr, dk, dv, dlog_w, du and ds0 (when asked)
    written once (seven tensors of r's size: four read, three written);
    per (batch·head, chunk of 16): four 16·dk·dk products (the reverse
    pass's r_decᵀ·dO, S_in·dO, dS_out·v, k_decᵀ·dS_out), v·dO over the
    chunk's pairs, three pair sums over s < t (an exp and three operations
    per channel: A, dr's and dk's intra terms), A·dO over s <= t, and the
    log-decay and u sums, counting an exp as one operation; from the
    checkpoints also the states' recompute (the state update's 16·dk·dk
    product, its decay and the k decays)."""
    b, s, h, dk = r.shape
    n = -(-s // CHUNK)
    es = r.element_size()
    mat = 4 * b * h * dk * dk
    nbytes = (7 * r.numel() * es + 2 * 4 * log_w.numel() + 2 * 4 * u.numel()
              + 4 * states.numel() + (0 if dst is None else mat)
              + (mat if want_ds0 else 0))
    c = CHUNK
    per = 4 * 2 * c * dk * dk + 2 * c * c * dk + 3 * 4 * c * (c - 1) // 2 \
        * dk + c * (c + 1) * dk + 6 * c * dk
    if states.shape[2] != n:
        per += 2 * c * dk * dk + dk * dk + 3 * c * dk
    return nbytes, b * h * n * per


def ssd_bwd_work(x, bmat, cmat, dt, a_log, d_skip, states, dy, dst=None,
                 want_ds0=False) -> tuple[int, int]:
    """(bytes, operations) one SSD backward call needs: x, dY, B, C, dt,
    a_log, D, the kept states (every chunk's, or every 16th's) and dsT
    (when given) read once, dx, dB, dC, ddt, da_log, dD and ds0 (when
    asked) written once (three tensors of x's size: x and dY read, dx
    written); per chunk of 16: C·Bᵀ once for all heads, and per head four
    16·hd·ds products (the reverse pass's, dS_out·B, S_inᵀ·dY,
    dS_outᵀ·x), x·dY over the pairs, the decay-weighted sums of dx, dC and
    dB over s <= t, the exps; from the checkpoints also the states'
    recompute (per head the state update's 16·hd·ds product and its
    decay)."""
    b, s, h, hd = x.shape
    ds = bmat.shape[-1]
    n = -(-s // CHUNK)
    es = x.element_size()
    mat = 4 * b * h * hd * ds
    nbytes = (3 * x.numel() * es + 4 * bmat.numel() * es + 2 * 4 * dt.numel()
              + 4 * 4 * h + 4 * states.numel()
              + (0 if dst is None else mat) + (mat if want_ds0 else 0))
    c = CHUNK
    pairs = c * (c + 1) // 2
    per_head = 4 * 2 * c * hd * ds + 2 * c * c * hd + pairs * 2 * hd \
        + pairs * 4 * ds * 2 + 3 * pairs + 8 * c * hd
    if states.shape[2] != n:
        per_head += 2 * c * hd * ds + hd * ds
    return nbytes, b * n * (2 * c * c * ds + h * per_head)

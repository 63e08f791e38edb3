"""Causal GQA attention over the KV cache and its CUDA kernel (port of
``sesameai_tts_tpu/ops/attention.py``).

q ``(B, H, S, hd)``; cache k, v ``(B, KV, T, hd)`` with ``G = H / KV``
query heads per KV head; ``pos0`` and ``valid_end`` ``(B,)`` integer
tensors on q's device.  Query row i of batch row b sits at position
``pos0[b] + i`` and sees cache slot t when ``t <= pos0[b] + i`` and
``t < valid_end[b]``.  Logits and softmax are f32, products are of the
operands' values with f32 accumulation, and a row that sees no slot gives
0 (not NaN).

- ``flash_attention_plain``: the function as torch ops, the trunk's
  attention on the CPU and the kernel's reference on the card;
- ``flash_attention_split_plain``: the decode kernel's arithmetic as
  torch ops (per-split partials, a fixed-order combine);
- ``flash_attention_tiled_plain``: the prefill kernels' arithmetic as
  torch ops (an online softmax over 64-key tiles);
- ``flash_attention``: for CUDA tensors it launches
  ``csrc/flash_attention.cu`` (or raises); for CPU tensors it runs the
  plain version.  ``flash_attention.launches`` counts launches.

They differ only in where the softmax weights are rounded to v's dtype
before the PV product: the plain version rounds the normalized
probabilities, the kernels (like the TPU kernel) round ``exp(s - m)`` at
the running max of each key tile and divide by the f32 sum at the end;
the decode kernel does so in each split of the keys at that split's own
max, then combines the splits with weights ``exp(m_j - m)`` in f32.  In
f32 none rounds; in bf16 each weight moves by at most 2^-9 of itself in
every one.
"""

from __future__ import annotations

import math

import torch

from sesameai_tts_tpu_torch.ops.kernels import check_operands, launch

_HEAD_DIMS = (16, 64, 128)  # the head dims flash_attention.cu is built for
_QUERIES_PER_BLOCK = 16  # WARPS * Tile::QPW of flash_attention.cu: G may not exceed it
# the kernel a call runs (ROUTE_* of flash_attention.cu)
_ROUTES = {"fma": 0, "mma": 1, "split": 2}
# flash_fwd_mma, the tensor-core prefill: its head dims (bf16 only), the
# query vectors of a block (MMA_VECS) and the keys of a K/V tile (MMA_BK)
_MMA_HEAD_DIMS = (64, 128)
_MMA_VECTORS = 64
_MMA_BLOCK_K = 64
# flash_fwd_split, the split-K decode kernel: the query vectors (G * S) a
# block holds (RQ), its warps, the most blocks of a cluster (MAX_SPLITS)
# and the blocks aimed at per SM
_DECODE_QUERIES = 4
_DECODE_WARPS = 4
_DECODE_MAX_SPLITS = 16
_DECODE_BLOCKS_PER_SM = 2


def _decode_tile(hd: int, elem: int) -> int:
    """Split<T, HD>::WK: keys per warp tile (its K and V in 8 KB)."""
    return min(32, 8192 // (2 * hd * elem))


def _decode_splits(B: int, KV: int, T: int, hd: int, elem: int, sms: int) -> int:
    """Cluster size of a split-K decode call, a power of two: enough blocks
    that each warp walks at most one tile of keys when the whole cache of T
    slots is visible, at most ``_DECODE_MAX_SPLITS``, and no more than
    ``_DECODE_BLOCKS_PER_SM`` blocks per SM over the B * KV clusters.  The
    visible length is on the card, so only T and the card decide."""
    tiles = math.ceil(T / (_DECODE_WARPS * _decode_tile(hd, elem)))
    cap = min(_DECODE_MAX_SPLITS, 1 << (tiles - 1).bit_length(),
              max(1, _DECODE_BLOCKS_PER_SM * sms // (B * KV)))
    return 1 << (cap.bit_length() - 1)


def _route(dtype: torch.dtype, hd: int, G: int, S: int) -> str:
    """The kernel of a call, from its shape and dtype: a decode call (every
    head of a KV group, all S rows, in G * S <= 4 query vectors) runs
    split-K over the cache ("split"); a bf16 prefill at hd 64 or 128 runs
    on tensor cores ("mma"); any other prefill (f32, hd 16) on CUDA cores
    ("fma"), whose f32 products keep an f32 model's card run equal to the
    CPU's."""
    if G * S <= _DECODE_QUERIES:
        return "split"
    if dtype == torch.bfloat16 and hd in _MMA_HEAD_DIMS:
        return "mma"
    return "fma"


def _mma_tile_plan(S: int, G: int, T: int, pos0: int, valid_end: int):
    """The tensor-core prefill's plan for one batch row: query tiles of
    ``BQ = 64 // G`` rows (a block each, all G heads of a KV head) →
    [(q0, rows, key tiles visited, key tiles masked)], tiles by their first
    key.  A tile is visited when its first key is below the visible end of
    the query tile's last row, ``min(valid_end, pos0 + q0 + rows, T)``, and
    masked when it reaches past the visible end of the first row: every
    other visited tile is seen whole by every row."""
    BQ = _MMA_VECTORS // G
    plan = []
    for q0 in range(0, S, BQ):
        rows = min(BQ, S - q0)
        kend, full = (max(0, min(valid_end, pos0 + q0 + i + 1, T)) for i in (rows - 1, 0))
        tiles = list(range(0, kend, _MMA_BLOCK_K))
        plan.append((q0, rows, tiles, [kt for kt in tiles if kt + _MMA_BLOCK_K > full]))
    return plan


def _split_ranges(kend: int, workers: int):
    """The decode kernel's key ranges: worker w of ``workers`` (a cluster's
    blocks × their warps, in rank-then-warp order) takes the keys
    ``[lo, hi)`` of an even, contiguous share of ``[0, kend)``; a share
    past ``kend`` is empty (lo == hi)."""
    chunk = -(-kend // workers)
    out = []
    for w in range(workers):
        lo = min(kend, w * chunk)
        out.append((lo, min(kend, lo + chunk)))
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos0: torch.Tensor, valid_end: torch.Tensor) -> torch.Tensor:
    """The function as torch ops: the positional mask, f32 logits over
    every cache slot, softmax, the probabilities rounded to v's dtype,
    then the PV product in f32 → (B, H, S, hd) in v's dtype.  Operands are
    upcast to f32 before each product: exact for bf16 inputs, so this is
    bf16 × bf16 with f32 accumulation, as in the JAX package's
    ``models/transformer.py::_attention``."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    positions = pos0[:, None] + torch.arange(S, device=q.device)[None, :]  # (B, S)
    key_pos = torch.arange(T, device=q.device)
    mask = key_pos[None, None, :] <= positions[:, :, None]  # (B, S, T)
    mask = mask & (key_pos[None, None, :] < valid_end[:, None, None])
    qf = q.reshape(B, KV, G, S, hd).float()
    logits = torch.einsum("bkgsh,bkth->bkgst", qf, k.float()) * (1.0 / math.sqrt(hd))
    m = mask[:, None, None, :, :]
    logits = logits.masked_fill(~m, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # a fully masked row (a batched prefill row with valid_len=0) softmaxes
    # to NaN; zero it so an idle row stays finite
    probs = torch.where(m.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bkgst,bkth->bkgsh", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, H, S, hd).to(v.dtype)


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                pos0: torch.Tensor, valid_end: torch.Tensor,
                                splits: int) -> torch.Tensor:
    """The split-K decode kernel's arithmetic as torch ops.  The visible
    slots ``[0, kend)``, ``kend = min(valid_end, pos0 + S, T)``, are cut
    into ``splits`` even, contiguous key ranges (``_split_ranges``; the
    kernel at cluster size c has ``c * 4`` of them, one per warp).  Each
    range j gives f32 logits, its max m_j (-inf when it sees nothing),
    ``p = exp(s - m_j)`` summed unrounded into l_j and rounded to v's dtype
    before the PV product into acc_j.  The ranges are combined in order
    with weights ``exp(m_j - m)`` in f32, and the output is ``acc / max(l,
    1e-30)``: exactly 0 for a row that sees no slot.  (The kernel rounds p
    at a range's running max when the range spans several tiles; either
    moves a weight by at most 2^-9 of itself.)"""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    positions = pos0[:, None] + torch.arange(S, device=dev)[None, :]  # (B, S)
    key_pos = torch.arange(T, device=dev)
    causal = (key_pos[None, None, :] <= positions[:, :, None]) & (
        key_pos[None, None, :] < valid_end[:, None, None])  # (B, S, T)
    kend = torch.clamp(torch.minimum(torch.minimum(valid_end, pos0 + S),
                                     torch.full_like(pos0, T)), min=0)
    ranges = torch.tensor([_split_ranges(int(e), splits) for e in kend.tolist()],
                          device=dev).reshape(B, splits, 2)
    qf = q.reshape(B, KV, G, S, hd).float()
    logits = torch.einsum("bkgsh,bkth->bkgst", qf, k.float()) * (1.0 / math.sqrt(hd))
    parts = []
    for j in range(splits):
        lo, hi = ranges[:, j, 0], ranges[:, j, 1]
        in_range = (key_pos[None, :] >= lo[:, None]) & (key_pos[None, :] < hi[:, None])
        mask = (causal & in_range[:, None, :])[:, None, None]  # (B, 1, 1, S, T)
        s = logits.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
        acc = torch.einsum("bkgst,bkth->bkgsh", p.to(v.dtype).float(), v.float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_tot = torch.zeros_like(m_all)
    acc_tot = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - torch.where(torch.isfinite(m_all),
                                                                     m_all, 0.0)), 0.0)
        l_tot = l_tot + l * w
        acc_tot = acc_tot + acc * w
    out = acc_tot / torch.clamp_min(l_tot, 1e-30)
    return out.reshape(B, H, S, hd).to(v.dtype)


def flash_attention_tiled_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                pos0: torch.Tensor, valid_end: torch.Tensor,
                                block_k: int = _MMA_BLOCK_K) -> torch.Tensor:
    """The prefill kernels' arithmetic as torch ops (the TPU kernel's at
    ``block_k``): an online softmax over key tiles of ``block_k`` slots.
    Per tile, f32 logits under the positional mask, the running max m,
    ``p = exp(s - m)`` (0 where masked) summed unrounded into l and rounded
    to v's dtype before the PV product into the f32 accumulator, both
    rescaled by ``exp(m_old - m)``; the output is ``acc / max(l, 1e-30)``:
    exactly 0 for a row that sees no slot.  Tiles no row sees leave every
    sum unchanged, as the kernels' skipping them does."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    positions = pos0[:, None] + torch.arange(S, device=dev)[None, :]  # (B, S)
    key_pos = torch.arange(T, device=dev)
    mask = ((key_pos[None, None, :] <= positions[:, :, None])
            & (key_pos[None, None, :] < valid_end[:, None, None]))[:, None, None]
    qf = q.reshape(B, KV, G, S, hd).float()
    logits = torch.einsum("bkgsh,bkth->bkgst", qf, k.float()) * (1.0 / math.sqrt(hd))
    logits = logits.masked_fill(~mask, float("-inf"))
    m = torch.full((B, KV, G, S, 1), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, S, hd), device=dev)
    for kt in range(0, T, block_k):
        s = logits[..., kt:kt + block_k]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        p = torch.exp(s - m_safe)  # exp(-inf) = 0 where masked
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,bkth->bkgsh", p.to(v.dtype).float(),
                                         v[:, :, kt:kt + block_k].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, H, S, hd).to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos0: torch.Tensor,
                    valid_end: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention of q (B, H, S, hd) over the cache k, v (B, KV,
    T, hd) → (B, H, S, hd) in q's dtype.  CUDA tensors launch the kernel
    (or raise); CPU tensors run ``flash_attention_plain``.

    On the card q, k and v are all bf16 or all f32, hd is 16, 64 or 128,
    at most 16 heads share a KV head, k and v are contiguous and 16-byte
    aligned, and q's last dim is contiguous (q may be a transposed view;
    for a bf16 prefill at hd 64 or 128, which ``_route`` sends to the
    tensor-core kernel, q is 16-byte aligned with strides that are
    multiples of 8).  ``pos0`` and ``valid_end`` stay on the card: the
    kernel reads them itself, so a call never waits for the host.  The result is a
    (B, H, S, hd) view of a (B, S, H, hd) buffer, so that the caller's
    merge of the heads is free."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pos0, valid_end)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or pos0.dim() != 1 or valid_end.dim() != 1:
        raise ValueError("flash_attention: want q (B, H, S, hd), k and v (B, KV, T, hd), "
                         "pos0 and valid_end (B,)")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % KV != 0
            or pos0.shape[0] != B or valid_end.shape[0] != B or min(B, S, T) < 1):
        raise ValueError(
            f"flash_attention: shape mismatch q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, pos0 {tuple(pos0.shape)}, valid_end {tuple(valid_end.shape)}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: want q, k, v all bf16 or all f32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos0.dtype.is_floating_point or valid_end.dtype.is_floating_point or (
        torch.bool in (pos0.dtype, valid_end.dtype)
    ):
        raise TypeError("flash_attention: pos0 and valid_end must be integer tensors")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {_HEAD_DIMS}")
    if H // KV > _QUERIES_PER_BLOCK:
        raise ValueError(f"flash_attention: {H // KV} heads per KV head exceed "
                         f"{_QUERIES_PER_BLOCK}")
    check_operands("flash_attention", {"k": k, "v": v}, q.device)
    if k.data_ptr() % 16 or v.data_ptr() % 16:  # the kernel reads k and v as 16-byte vectors
        raise ValueError("flash_attention: k and v must start on a 16-byte boundary")
    for key, t in (("pos0", pos0), ("valid_end", valid_end)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {key} is on {t.device}, not {q.device}")
    if q.stride(3) != 1 or max(q.stride()) >= 2**31 or B * H * S * hd >= 2**31:
        raise ValueError("flash_attention: q's last dim must be contiguous and its strides "
                         "below 2^31")
    route = _route(q.dtype, hd, H // KV, S)
    if route == "mma" and (q.data_ptr() % 16 or any(st % 8 for st in q.stride()[:3])):
        raise ValueError("flash_attention: a bf16 prefill reads q's rows as 16-byte vectors: q "
                         "must start on a 16-byte boundary with strides that are multiples of 8")
    pos0 = pos0.to(torch.int64).contiguous()  # no-ops for the trunk's int64 positions
    valid_end = valid_end.to(torch.int64).contiguous()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    splits = 0
    if route == "split":
        splits = _decode_splits(B, KV, T, hd, q.element_size(),
                                torch.cuda.get_device_properties(q.device).multi_processor_count)
    launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), pos0.data_ptr(),
           valid_end.data_ptr(), out.data_ptr(), B, H, KV, S, T, hd, q.stride(0),
           q.stride(1), q.stride(2), out.stride(0), out.stride(1), out.stride(2),
           _ROUTES[route], splits, int(q.dtype == torch.bfloat16),
           torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

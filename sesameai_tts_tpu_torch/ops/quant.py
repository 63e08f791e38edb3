"""Weight-only int8 and int4 quantization and their CUDA kernels (port of
``sesameai_tts_tpu/ops/quant.py``).

An int8 weight is the dict ``{"q": int8 (in, out), "scale": f32 (out,)}``;
an int4 weight is ``{"q4": int8 (in/2, out), "scale": f32 (G, out)}``, two
nibbles per byte in the split-half layout (byte ``[d, f]`` holds row ``d``
in its low nibble and row ``d + in/2`` in its high nibble) with one scale
per group of ``in/G`` rows.  Either is a drop-in leaf of the per-layer
trunk dicts.  Single-stream AR decode streams every trunk weight once per
step, so the kernels read the quantized weight straight from device memory
and never materialize a bf16 copy of it:

- ``quant_matmul`` (``csrc/quant_matmul.cu``): x @ int8 weight;
- ``quant4_matmul`` (``csrc/quant4_matmul.cu``): x @ int4 weight;
- ``quant_mlp`` (``csrc/quant_mlp.cu``): the whole int8 SwiGLU MLP in one
  launch, taken by ``qmlp`` when the caller asks for the fused MLP.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (the same arithmetic as torch ops) for a CPU tensor.  The kernels
are built at first use by ``ops/kernels.py``, so importing this module
needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F_

from sesameai_tts_tpu_torch.ops.kernels import check_operands, launch

_MIN_SPLIT_ROWS = 32  # fewest weight rows one block reduces over
# quant_matmul.cu: threads per tile row, widest first (a tile is tpr * vec
# columns, at most MAX_COLS = 256), the most blocks of a cluster
# (MAX_CLUSTER), and the blocks aimed at per SM; quant4_matmul.cu shares
# the cluster bound
_QMM_TPRS = (16, 8, 4)
_QMM_MAX_CLUSTER = 16
_QMM_BLOCKS_PER_SM = 2
# quant4_matmul.cu: lane pairs per tile row, columns per pair by S tile (its
# (s_tile, vec) instantiations: fewer at wide S tiles, to keep two f32 sums
# per column and row of x within 128 registers), the packed weight bytes
# aimed at per block, and the bounds of that aim in blocks per SM
_Q4MM_TPR = 2
_Q4MM_VEC = {1: 16, 2: 16, 4: 8, 8: 4}
_Q4MM_BYTES_PER_BLOCK = 4096
_Q4MM_BLOCKS_PER_SM = (1, 2)
# quant_mlp.cu: intermediate tile widths, widest first; the cluster sizes,
# largest first; the clusters of each size one H100 holds at once with 1
# or 2 blocks per SM (csrc/probes/cluster_occupancy.cu, H100 80GB HBM3: a
# cluster lives in one GPC, and the GPCs hold unequal numbers of SMs), for
# 132 SMs; the shared memory one block may use and one SM holds (less 1 KB
# the card reserves per resident block); the most threads a block has
_QMLP_TILES = (256, 128, 64, 32)
_QMLP_CLUSTERS = (16, 8, 4, 2, 1)
_QMLP_CLUSTER_SLOTS = {1: {16: 7, 8: 15, 4: 30, 2: 66, 1: 132},
                       2: {16: 14, 8: 30, 4: 62, 2: 132, 1: 264}}
_QMLP_SLOT_SMS = 132
_QMLP_MAX_SMEM = 232448  # 227 KB
_QMLP_SM_SMEM = 233472  # 228 KB
_QMLP_BLOCK_RESERVED = 1024
_QMLP_MAX_THREADS = 512


def quantize_weight(w: torch.Tensor) -> dict:
    """(..., in, out) float → {"q": int8, "scale": f32 (..., out)}."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / 127.0  # per output channel
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def is_quantized4(w) -> bool:
    return isinstance(w, dict) and "q4" in w


def _dequant(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (w["q"].float() * w["scale"][..., None, :]).to(dtype)


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> dict:
    """(in, out) float → {"q4": int8 (in/2, out) packed nibbles, "scale":
    f32 (in/group, out)}: ``clip(round(w / s), -8, 7)`` per group of
    ``group`` input rows, packed split-half."""
    wf = w.float()
    D, F = wf.shape
    if D % (2 * group) != 0:
        raise ValueError(f"in-dim {D} not divisible by 2*group={2 * group}")
    G = D // group
    gw = wf.reshape(G, group, F)
    scale = torch.clamp_min(gw.abs().amax(dim=1) / 7.0, 1e-8)  # (G, F)
    q = torch.clamp(torch.round(gw / scale[:, None, :]), -8, 7).to(torch.int8).reshape(D, F)
    lo, hi = q[: D // 2], q[D // 2:]
    packed = torch.bitwise_or(torch.bitwise_and(lo, 0x0F), torch.bitwise_left_shift(hi, 4))
    return {"q4": packed, "scale": scale}


def _unpack_int4(packed: torch.Tensor):
    """(D/2, F) packed → (lo (D/2, F), hi (D/2, F)) int8 in [-8, 7]."""
    lo = torch.bitwise_xor(torch.bitwise_and(packed, 0x0F), 8) - 8  # sign-extend
    hi = torch.bitwise_right_shift(packed, 4)  # arithmetic shift on int8
    return lo, hi


def _dequant4(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    lo, hi = _unpack_int4(w["q4"])
    q = torch.cat([lo, hi], dim=0).float()  # (D, F)
    G, F = w["scale"].shape
    D = q.shape[0]
    return (q.reshape(G, D // G, F) * w["scale"][:, None, :]).reshape(D, F).to(dtype)


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------


def _s_tile(S: int) -> int:
    return 1 if S == 1 else 2 if S == 2 else 4 if S <= 4 else 8


def _qmm_geometry(S: int, D: int, F: int, sms: int):
    """quant_matmul.cu's launch → (vec, tpr, splits, rows_per_split,
    s_tile).  Each thread reads ``vec`` columns (16, or 8 when F % 16 != 0)
    and ``tpr`` threads cover a tile row; the widest tile is taken whose
    grid can still reach ``_QMM_BLOCKS_PER_SM`` blocks per SM with clusters
    of at most ``_QMM_MAX_CLUSTER`` blocks, then the fewest splits of D
    that reach it (or the most allowed), at least ``_MIN_SPLIT_ROWS`` rows
    each.  One cluster is the ``splits`` blocks of a column tile; every
    split is non-empty."""
    vec = 16 if F % 16 == 0 else 8
    s_tile = _s_tile(S)
    s_tiles = math.ceil(S / s_tile)
    max_splits = max(1, min(_QMM_MAX_CLUSTER, D // _MIN_SPLIT_ROWS))
    want = _QMM_BLOCKS_PER_SM * sms
    for tpr in _QMM_TPRS:
        tiles = math.ceil(F / (vec * tpr)) * s_tiles
        if tiles * max_splits >= want:
            break
    splits = max(1, min(max_splits, math.ceil(want / tiles)))
    rows = math.ceil(math.ceil(D / splits) / 8) * 8
    return vec, tpr, math.ceil(D / rows), rows, s_tile


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# quant_matmul: x @ int8 weight
# ---------------------------------------------------------------------------


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic as torch ops: bf16(x) @ bf16(q) with f32
    accumulation (bf16 × bf16 products are exact in f32), × scale in f32,
    cast to x.dtype.  For the CPU tests and the on-card comparison."""
    acc = x.to(torch.bfloat16).float() @ q.to(torch.bfloat16).float()
    return (acc * scale.float()).to(x.dtype)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (S, D) bf16|f32 @ dequant(q (D, F) int8, scale (F,) f32) → (S, F)
    in x.dtype.  CUDA tensors launch the kernel (or raise); CPU tensors run
    ``quant_matmul_plain``.  ``quant_matmul.launches`` counts launches."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(
            f"quant_matmul: want x (S, D), q (D, F), scale (F,); got "
            f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}"
        )
    S, D = x.shape
    D2, F = q.shape
    if D2 != D or scale.shape[0] != F:
        raise ValueError(
            f"quant_matmul: shape mismatch x {tuple(x.shape)}, q {tuple(q.shape)}, "
            f"scale {tuple(scale.shape)}"
        )
    if x.dtype not in (torch.bfloat16, torch.float32) or q.dtype != torch.int8 or (
        scale.dtype != torch.float32
    ):
        raise TypeError(
            f"quant_matmul: want x bf16|f32, q int8, scale f32; got "
            f"{x.dtype}, {q.dtype}, {scale.dtype}"
        )
    check_operands("quant_matmul", {"x": x, "q": q, "scale": scale}, x.device)
    if F % 8 != 0 or S * F >= 2**31:
        raise ValueError(f"quant_matmul: need F % 8 == 0 and S*F < 2^31 (S={S}, F={F})")
    vec, tpr, splits, rows, s_tile = _qmm_geometry(S, D, F, _sms(x.device))
    y = torch.empty((S, F), dtype=x.dtype, device=x.device)
    launch("quant_matmul", x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
           S, D, F, splits, rows, tpr, vec, s_tile, int(x.dtype == torch.bfloat16),
           torch.cuda.current_stream(x.device).cuda_stream)
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0


# ---------------------------------------------------------------------------
# quant4_matmul: x @ int4 weight
# ---------------------------------------------------------------------------


def _q4mm_geometry(S: int, D: int, F: int, G: int, sms: int):
    """quant4_matmul.cu's launch → (vec, tpr, splits, rows_per_split,
    s_tile).  A pair of lanes reads ``vec`` columns of a packed row (16 at
    S tiles of 1-2, fewer at wider ones) and ``_Q4MM_TPR`` pairs cover a
    tile row: the narrowest tile, so that the fewest splits (the smallest
    clusters, the cheapest barrier) fill the card.  The grid aims at one
    block per ``_Q4MM_BYTES_PER_BLOCK`` packed bytes, held between 1 and 2
    blocks per SM, and takes the fewest splits of the D/2 packed rows that
    reach it (or the most allowed), at least ``_MIN_SPLIT_ROWS`` rows
    each, in clusters of at most ``_QMM_MAX_CLUSTER``.  One cluster is the
    ``splits`` blocks of a column tile; every split is non-empty.  A split
    may cut a scale group of D/G packed rows or span several: the kernel
    scales each group where a block's rows leave it (``_q4mm_segments``)."""
    if G <= 0 or G % 2 or D % G:
        raise ValueError(f"quant4_matmul: G={G} must be even and divide D={D}")
    s_tile = _s_tile(S)
    vec = _Q4MM_VEC[s_tile]
    if F % vec:
        vec = 8  # F % 8 == 0: the S tile's instantiation at 8 columns
    D2 = D // 2
    tiles = math.ceil(F / (vec * _Q4MM_TPR)) * math.ceil(S / s_tile)
    max_splits = max(1, min(_QMM_MAX_CLUSTER, D2 // _MIN_SPLIT_ROWS))
    lo, hi = (n * sms for n in _Q4MM_BLOCKS_PER_SM)
    want = min(hi, max(lo, D2 * F / _Q4MM_BYTES_PER_BLOCK))
    for want_splits in range(min(max_splits, math.ceil(want / tiles)), max_splits + 1):
        rows = math.ceil(math.ceil(D2 / want_splits) / 8) * 8
        splits = math.ceil(D2 / rows)
        if splits * tiles >= want:
            break
    return vec, _Q4MM_TPR, splits, rows, s_tile


def _q4mm_segments(D: int, G: int, begin: int, end: int):
    """The scale groups that packed rows [begin, end) of a block touch, in
    order → [(group, first row, end row)]: every group once, cut to the
    block's rows.  Packed row d is in group d // (D/G) of each half."""
    gs = D // G
    return [(g, max(begin, g * gs), min(end, (g + 1) * gs))
            for g in range(begin // gs, (end - 1) // gs + 1)] if end > begin else []


def quant4_matmul_cluster_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                                rows_per_split: int) -> torch.Tensor:
    """The kernel's order of sums as torch ops: the D/2 packed rows are cut
    into splits of ``rows_per_split`` (one block each); a block takes, for
    each group its rows touch (``_q4mm_segments``), the f32 partial dots of
    bf16(x)'s low half with the low nibbles and of its high half with the
    high nibbles over its rows of the group, times the group's two scales,
    into its running f32 sum; the blocks' sums are added in rank order and
    cast to x.dtype.  (The kernel scales each thread's share of a group and
    adds the shares inside the block: the same terms, f32 sums in another
    order.)"""
    S, D = x.shape
    G, F = scale.shape
    D2 = D // 2
    lo, hi = (n.float() for n in _unpack_int4(q4))
    xb = x.to(torch.bfloat16).float()
    x_lo, x_hi = xb[:, :D2], xb[:, D2:]
    total = torch.zeros((S, F), dtype=torch.float32, device=x.device)
    for begin in range(0, D2, rows_per_split):
        block = torch.zeros_like(total)
        for g, a, b in _q4mm_segments(D, G, begin, min(D2, begin + rows_per_split)):
            block = (block + (x_lo[:, a:b] @ lo[a:b]) * scale[g].float()
                     + (x_hi[:, a:b] @ hi[a:b]) * scale[G // 2 + g].float())
        total = total + block
    return total.to(x.dtype)


def quant4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic as torch ops: per scale group, the partial
    dots of bf16(x)'s low half with the low nibbles and of its high half
    with the high nibbles, in f32; each times its group's scale, summed in
    f32 and cast to x.dtype.  For the CPU tests and the on-card comparison."""
    S, D = x.shape
    G, F = scale.shape
    G2, group = G // 2, D // G
    lo, hi = _unpack_int4(q4)
    xb = x.to(torch.bfloat16).float()
    p_lo = torch.einsum("sgk,gkf->sgf", xb[:, : D // 2].reshape(S, G2, group),
                        lo.float().reshape(G2, group, F))
    p_hi = torch.einsum("sgk,gkf->sgf", xb[:, D // 2:].reshape(S, G2, group),
                        hi.float().reshape(G2, group, F))
    acc = (p_lo * scale[:G2].float() + p_hi * scale[G2:].float()).sum(dim=1)
    return acc.to(x.dtype)


def quant4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (S, D) bf16 @ dequant4(q4 (D/2, F) int8, scale (G, F) f32) → (S, F)
    bf16.  CUDA tensors launch the kernel (or raise); CPU tensors run
    ``quant4_matmul_plain``.  ``quant4_matmul.launches`` counts launches."""
    if x.device.type == "cpu":
        return quant4_matmul_plain(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant4_matmul: unsupported device {x.device}")
    if x.dim() != 2 or q4.dim() != 2 or scale.dim() != 2:
        raise ValueError(
            f"quant4_matmul: want x (S, D), q4 (D/2, F), scale (G, F); got "
            f"{tuple(x.shape)}, {tuple(q4.shape)}, {tuple(scale.shape)}"
        )
    S, D = x.shape
    D2, F = q4.shape
    G = scale.shape[0]
    if D != 2 * D2 or scale.shape[1] != F or G % 2 != 0 or D % G != 0:
        raise ValueError(
            f"quant4_matmul: shape mismatch x {tuple(x.shape)}, q4 {tuple(q4.shape)}, "
            f"scale {tuple(scale.shape)} (want D = 2*D/2, G even, D % G == 0)"
        )
    if x.dtype != torch.bfloat16 or q4.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(
            f"quant4_matmul: want x bf16, q4 int8, scale f32; got "
            f"{x.dtype}, {q4.dtype}, {scale.dtype}"
        )
    check_operands("quant4_matmul", {"x": x, "q4": q4, "scale": scale}, x.device)
    if F % 8 != 0 or S * F >= 2**31:
        raise ValueError(f"quant4_matmul: need F % 8 == 0 and S*F < 2^31 (S={S}, F={F})")
    if q4.data_ptr() % 16 or scale.data_ptr() % 16:  # read as 16-byte vectors
        raise ValueError("quant4_matmul: q4 and scale must start on a 16-byte boundary")
    vec, tpr, splits, rows, s_tile = _q4mm_geometry(S, D, F, G, _sms(x.device))
    y = torch.empty((S, F), dtype=torch.bfloat16, device=x.device)
    launch("quant4_matmul", x.data_ptr(), q4.data_ptr(), scale.data_ptr(), y.data_ptr(),
           S, D, F, G, splits, rows, tpr, vec, s_tile,
           torch.cuda.current_stream(x.device).cuda_stream)
    quant4_matmul.launches += 1
    return y


quant4_matmul.launches = 0


# ---------------------------------------------------------------------------
# quant_mlp: the fused int8 SwiGLU MLP
# ---------------------------------------------------------------------------


def _qmlp_s_tile(S: int) -> int:
    return 1 if S == 1 else 2 if S == 2 else 4


def _qmlp_smem_bytes(S: int, block_i: int, Dout: int, threads: int, cluster: int,
                     prefetch_rows: int) -> int:
    """quant_mlp.cu's ``layout(...).total``: the mbarrier, the prefetched w2
    rows, h of every S tile, the larger of the phase-1 warp sums and the
    phase-2 slice sums, and the cluster's receive slots."""
    s_tile = _qmlp_s_tile(S)
    rg2 = min(max(1, threads // (Dout // 8)), block_i)
    slice_ = -(-(Dout // 4) // cluster) * 4
    return (16 + -(-prefetch_rows * Dout // 16) * 16 + -(-S // s_tile) * s_tile * block_i * 4
            + max(threads // 32 * s_tile * 2 * block_i * 4, rg2 * s_tile * Dout * 4)
            + cluster * s_tile * slice_ * 4)


def _qmlp_geometry(S: int, D: int, F: int, Dout: int, sms: int):
    """quant_mlp.cu's launch → (block_i, cluster, threads, prefetch_rows,
    smem, s_tile).  The widest tile whose F / block_i blocks still reach
    every SM (else the narrowest), k = ceil(blocks / SMs) blocks per SM of
    512 / k threads (at most 8 * block_i: 64 row groups), and the largest
    cluster that divides the grid and whose clusters the card holds at once
    with k blocks per SM (``_QMLP_CLUSTER_SLOTS``, scaled to ``sms``): one
    wave.  The w2 tile is prefetched whole where a block's share of the
    SM's shared memory holds it, else its first rows (an even count), and
    ``smem`` asks for enough shared memory that no (k+1)-th block fits on
    an SM.  D does not enter: x is not staged."""
    if F % _QMLP_TILES[-1] or Dout % 8 or not 1 <= S <= 64:
        raise ValueError(f"quant_mlp: need F % {_QMLP_TILES[-1]} == 0, Dout % 8 == 0 and "
                         f"1 <= S <= 64 (S={S}, F={F}, Dout={Dout})")
    block_i = next((b for b in _QMLP_TILES if F % b == 0 and F // b >= sms), _QMLP_TILES[-1])
    blocks = F // block_i
    per_sm = min(2, -(-blocks // sms))
    threads = min(_QMLP_MAX_THREADS // per_sm, 8 * block_i)
    slots = _QMLP_CLUSTER_SLOTS[per_sm]
    cluster = next((c for c in _QMLP_CLUSTERS
                    if blocks % c == 0 and blocks // c <= slots[c] * sms // _QMLP_SLOT_SMS), None)
    if cluster is None:
        raise ValueError(f"quant_mlp: F={F} needs {blocks} blocks, more than one wave holds")
    budget = min(_QMLP_MAX_SMEM, _QMLP_SM_SMEM // per_sm - _QMLP_BLOCK_RESERVED)
    rows = block_i
    while rows > 0 and _qmlp_smem_bytes(S, block_i, Dout, threads, cluster, rows) > budget:
        rows -= 2
    need = _qmlp_smem_bytes(S, block_i, Dout, threads, cluster, rows)
    if need > budget:
        raise ValueError(f"quant_mlp: S={S}, Dout={Dout} need more shared memory than a "
                         f"block has")
    spread = _QMLP_SM_SMEM // (per_sm + 1) - _QMLP_BLOCK_RESERVED + 16
    return block_i, cluster, threads, rows, min(budget, max(need, spread)), _qmlp_s_tile(S)


def _qmlp_parts(S: int, F: int, Dout: int, block_i: int, cluster: int) -> int:
    """f32 elements of the cluster partials one call keeps: F / block_i /
    cluster partials of (s_tile, Dout), twice when the call has more than
    one S tile."""
    s_tile = _qmlp_s_tile(S)
    return F // block_i // cluster * s_tile * Dout * (2 if S > s_tile else 1)


# per (device, stream): [f32 cluster partials, the grid barrier's int32
# word].  A buffer outgrown by a larger call stays referenced here: a
# captured CUDA graph may still read it
_qmlp_buffers: dict = {}
_qmlp_outgrown: list = []


def _qmlp_workspace(device: torch.device, numel: int):
    """The current stream's partials (at least ``numel`` f32) and barrier
    word, allocated outside any capture: the first call on a stream, and a call
    that needs more, must not be captured."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    entry = _qmlp_buffers.get(key)
    if entry is None or entry[0].numel() < numel:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quant_mlp: the stream's first call (or one that needs a larger "
                               "buffer) is inside a CUDA-graph capture; call it once on the "
                               "capturing stream before capturing")
        if entry is not None:
            _qmlp_outgrown.append(entry[0])
        word = entry[1] if entry else torch.zeros(1, dtype=torch.int32, device=device)
        entry = [torch.empty(numel, dtype=torch.float32, device=device), word]
        _qmlp_buffers[key] = entry
    return entry


def quant_mlp_plain(x: torch.Tensor, q13: torch.Tensor, s13: torch.Tensor, q2: torch.Tensor,
                    s2: torch.Tensor, block_i: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic as torch ops: a1, a3 = (bf16(x) @ q13) × s13
    in f32; h = bf16(bf16(silu(f32(bf16(a1)))) · bf16(a3)); each
    intermediate tile of ``block_i`` rows (default: one tile of all F)
    gives an f32 partial h_tile @ q2_tile, the partials are summed in f32,
    × s2, cast to x.dtype.  For the CPU tests and the on-card comparison;
    ``quant_mlp_cluster_plain`` sums the tiles in the kernel's order."""
    parts = _qmlp_tile_parts(x, q13, s13, q2, block_i or q13.shape[1] // 2)
    return (parts.sum(dim=0) * s2.float()).to(x.dtype)


def _qmlp_tile_parts(x, q13, s13, q2, block_i: int) -> torch.Tensor:
    """(F / block_i, S, Dout) f32: each intermediate tile's h_tile @ q2_tile."""
    S = x.shape[0]
    F = q13.shape[1] // 2
    Dout = q2.shape[1]
    a = (x.to(torch.bfloat16).float() @ q13.to(torch.bfloat16).float()) * s13.float()
    gate = F_.silu(a[:, :F].to(torch.bfloat16).float()).to(torch.bfloat16)
    h = (gate * a[:, F:].to(torch.bfloat16)).float()
    return torch.einsum("stb,tbo->tso", h.reshape(S, F // block_i, block_i),
                        q2.to(torch.bfloat16).float().reshape(F // block_i, block_i, Dout))


def quant_mlp_cluster_plain(x: torch.Tensor, q13: torch.Tensor, s13: torch.Tensor,
                            q2: torch.Tensor, s2: torch.Tensor, block_i: int,
                            cluster: int) -> torch.Tensor:
    """The kernel's order of sums as torch ops: the F / block_i tiles' f32
    partials (one block each) are added in rank order within each cluster
    of ``cluster`` consecutive tiles; the cluster partials are added in the
    order of quant_mlp.cu's grid sum: tpv = min(32, the next power of two
    of the cluster count) lanes, lane l adding clusters l, l + tpv, ... in
    order, then a tree that adds lane l + o into lane l for o = tpv/2, ...,
    1; × s2, cast to x.dtype.  (Inside a block the kernel adds a tile's
    rows in slices: the same terms, f32 sums in another order.)"""
    parts = _qmlp_tile_parts(x, q13, s13, q2, block_i)
    n = parts.shape[0] // cluster
    clusters = []
    for c in range(n):
        acc = parts[c * cluster]
        for r in range(1, cluster):
            acc = acc + parts[c * cluster + r]
        clusters.append(acc)
    tpv = 1
    while tpv < n and tpv < 32:
        tpv *= 2
    lanes = []
    for lane in range(tpv):
        acc = torch.zeros_like(parts[0])
        for k in range(lane, n, tpv):
            acc = acc + clusters[k]
        lanes.append(acc)
    o = tpv // 2
    while o >= 1:
        lanes = [lanes[i] + lanes[i + o] for i in range(o)]
        o //= 2
    return (lanes[0] * s2.float()).to(x.dtype)


def quant_mlp(x: torch.Tensor, q13: torch.Tensor, s13: torch.Tensor, q2: torch.Tensor,
              s2: torch.Tensor) -> torch.Tensor:
    """silu(x@W1)·(x@W3) @ W2 with all three weights int8, one kernel:
    x (S, D) bf16; q13 (D, 2F) int8 (w1 columns [:F], w3 [F:]); s13 (2F,)
    f32; q2 (F, Dout) int8; s2 (Dout,) f32 → (S, Dout) bf16.  CUDA tensors
    launch the kernel (or raise); CPU tensors run ``quant_mlp_plain``.
    ``quant_mlp.launches`` counts launches."""
    if x.device.type == "cpu":
        return quant_mlp_plain(x, q13, s13, q2, s2)
    if x.device.type != "cuda":
        raise ValueError(f"quant_mlp: unsupported device {x.device}")
    if x.dim() != 2 or q13.dim() != 2 or s13.dim() != 1 or q2.dim() != 2 or s2.dim() != 1:
        raise ValueError("quant_mlp: want x (S, D), q13 (D, 2F), s13 (2F,), q2 (F, Dout), "
                         "s2 (Dout,)")
    S, D = x.shape
    F = q13.shape[1] // 2
    Dout = q2.shape[1]
    if (q13.shape != (D, 2 * F) or s13.shape[0] != 2 * F or q2.shape[0] != F
            or s2.shape[0] != Dout):
        raise ValueError(
            f"quant_mlp: shape mismatch x {tuple(x.shape)}, q13 {tuple(q13.shape)}, "
            f"s13 {tuple(s13.shape)}, q2 {tuple(q2.shape)}, s2 {tuple(s2.shape)}"
        )
    if x.dtype != torch.bfloat16 or q13.dtype != torch.int8 or q2.dtype != torch.int8 or (
        s13.dtype != torch.float32 or s2.dtype != torch.float32
    ):
        raise TypeError("quant_mlp: want x bf16, q13 and q2 int8, s13 and s2 f32")
    check_operands("quant_mlp", {"x": x, "q13": q13, "s13": s13, "q2": q2, "s2": s2},
                    x.device)
    if D % 16 != 0:
        raise ValueError(f"quant_mlp: need D % 16 == 0 (D={D})")
    if q13.data_ptr() % 16 or q2.data_ptr() % 16 or s2.data_ptr() % 16:
        raise ValueError("quant_mlp: q13, q2 and s2 must start on a 16-byte boundary")
    block_i, cluster, threads, rows, smem, s_tile = _qmlp_geometry(S, D, F, Dout,
                                                                   _sms(x.device))
    part, barrier = _qmlp_workspace(x.device, _qmlp_parts(S, F, Dout, block_i, cluster))
    y = torch.empty((S, Dout), dtype=torch.bfloat16, device=x.device)
    launch("quant_mlp", x.data_ptr(), q13.data_ptr(), s13.data_ptr(), q2.data_ptr(),
           s2.data_ptr(), y.data_ptr(), part.data_ptr(), barrier.data_ptr(), S, D, F, Dout,
           block_i, cluster, threads, rows, smem, s_tile,
           torch.cuda.current_stream(x.device).cuda_stream)
    quant_mlp.launches += 1
    return y


quant_mlp.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def qdot(x: torch.Tensor, w: Union[torch.Tensor, dict]) -> torch.Tensor:
    """Matmul against a maybe-quantized weight. x: (..., in); w: (in, out)
    tensor, int8 dict or int4 dict.

    On the card every quantized product goes to its kernel (an int4 one
    with x cast to bf16 and the result cast back).  On the CPU it is the
    JAX package's CPU branch, ``x @ dequant(w, x.dtype)``, so the CPU tests
    compare like with like.

    Precision contract (as in the JAX package): the kernels compute bf16
    activations × bf16-dequantized weights with f32 accumulation; an f32
    caller gets f32 back, not f32 dot precision.
    """
    if is_quantized4(w):
        if x.device.type == "cuda":
            lead, D = x.shape[:-1], x.shape[-1]
            out = quant4_matmul(x.reshape(-1, D).to(torch.bfloat16).contiguous(),
                                w["q4"], w["scale"])
            return out.reshape(*lead, out.shape[-1]).to(x.dtype)
        return x @ _dequant4(w, x.dtype)
    if not is_quantized(w):
        return x @ w
    if x.device.type == "cuda":
        lead, D = x.shape[:-1], x.shape[-1]
        out = quant_matmul(x.reshape(-1, D).contiguous(), w["q"], w["scale"])
        return out.reshape(*lead, out.shape[-1])
    return x @ _dequant(w, x.dtype)


def qmlp(x: torch.Tensor, w13, w2, fused: bool = False) -> torch.Tensor:
    """SwiGLU MLP against maybe-quantized weights: silu(x@W1)·(x@W3) @ W2.

    ``fused`` (the fused-MLP configuration) with both weights int8, x on
    the card and at most 64 rows sends the MLP to the ``quant_mlp`` kernel
    in one launch, x cast to bf16 and the result cast back.  Otherwise it
    is the unfused sequence of two ``qdot``s, the JAX package's default.
    """
    S = x.numel() // x.shape[-1]
    if fused and is_quantized(w13) and is_quantized(w2) and x.device.type == "cuda" and S <= 64:
        lead, D = x.shape[:-1], x.shape[-1]
        out = quant_mlp(x.reshape(S, D).to(torch.bfloat16).contiguous(), w13["q"],
                        w13["scale"], w2["q"], w2["scale"])
        return out.reshape(*lead, out.shape[-1]).to(x.dtype)
    a = qdot(x, w13)
    F = a.shape[-1] // 2
    gate = F_.silu(a[..., :F].float()).to(x.dtype)
    return qdot(gate * a[..., F:], w2)


# ---------------------------------------------------------------------------
# Parameter-tree helpers
# ---------------------------------------------------------------------------

_TRUNK_QUANT_KEYS = ("qkv", "o_proj", "w13", "w2")


def dequantize_csm(params: dict, dtype=torch.bfloat16) -> dict:
    """Materialize dense trunks from an int8 or int4 tree once (the prefill
    shadow: long prefills are compute-bound and run as a plain forward).
    Non-trunk leaves are shared by reference."""

    def deq_leaf(w):
        if is_quantized4(w):
            return _dequant4(w, dtype)
        return _dequant(w, dtype) if is_quantized(w) else w

    def deq_trunk(trunk):
        return {
            "layers": tuple({k: deq_leaf(v) for k, v in wl.items()} for wl in trunk["layers"]),
            "final_norm": trunk["final_norm"],
        }

    out = dict(params)
    out["backbone"] = deq_trunk(params["backbone"])
    out["decoder"] = deq_trunk(params["decoder"])
    return out


def quantize_trunk(trunk_params: dict, bits: int = 8, group: Optional[int] = None) -> dict:
    """Quantize qkv, o_proj, w13 and w2 of every layer: per-channel int8
    (``bits=8``) or group-wise int4 (``bits=4``) with half-matrix groups
    (``group = in_dim // 2``) unless ``group`` is given."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: only int8 (8) and int4 (4) are supported")
    layers = []
    for wl in trunk_params["layers"]:
        wl = dict(wl)
        for k in _TRUNK_QUANT_KEYS:
            w = wl[k]
            wl[k] = (quantize_weight_int4(w, group or w.shape[-2] // 2) if bits == 4
                     else quantize_weight(w))
        layers.append(wl)
    return {"layers": tuple(layers), "final_norm": trunk_params["final_norm"]}


def quantize_csm(params: dict, backbone: bool = True, decoder: bool = True,
                 bits: int = 8) -> dict:
    """Quantize the trunks; embeddings and the small per-frame heads stay
    in the model dtype.  ``bits=4`` packs nibbles with half-matrix scale
    groups (see ``quantize_trunk``)."""
    out = dict(params)
    if backbone:
        out["backbone"] = quantize_trunk(params["backbone"], bits)
    if decoder:
        out["decoder"] = quantize_trunk(params["decoder"], bits)
    return out

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

All three take one of two routes by S (``quant_route``): the CUDA cores at
S = 1 ("simt"), the tensor cores for 2 <= S <= 64 ("mma").

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (the same arithmetic as torch ops) for a CPU tensor.  The kernels
are built at first use by ``ops/kernels.py``, so importing this module
needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F_

from sesameai_tts_tpu_torch.ops.kernels import check_operands, count_launch, launch

_MIN_SPLIT_ROWS = 32  # fewest weight rows one block reduces over
# quant_matmul.cu: threads per tile row, widest first (a tile is tpr * vec
# columns, at most MAX_COLS = 256), the most blocks of a cluster
# (MAX_CLUSTER), and the blocks aimed at per SM; quant4_matmul.cu shares
# the cluster bound
_QMM_TPRS = (16, 8, 4)
_QMM_MAX_CLUSTER = 16
_QMM_BLOCKS_PER_SM = 2
# quant4_matmul.cu: lane pairs per tile row, the packed weight bytes aimed
# at per block, and the bounds of that aim in blocks per SM
_Q4MM_TPR = 2
_Q4MM_BYTES_PER_BLOCK = 4096
_Q4MM_BLOCKS_PER_SM = (1, 2)
# the tensor-core route (qmm_mma, q4mm_mma): rows of D a k-step, warps a
# block, and per n-tiles of 8 rows of x a warp (1, 2, 4, 8) the m-tiles of
# 16 columns a warp and the warps along D (the rest go along F): the
# accumulators stay at <= 64 f32 a lane, and from S = 17 on the block
# widens in F so that its staged x rows stay small beside its weight bytes;
# then (int4) the groups of 4 warps a block, which split the n-tiles (at
# S > 32 its 2 x 64 accumulators would leave one block of 4 warps an SM;
# quant_matmul.cu has one group).
# The splits: at least _MMA_SPLIT_ROWS weight rows each (a packed int4 row
# holds two), at most _MMA_BLOCKS_PER_SM blocks per SM in all; S > 16
# halves the rows and takes a power-of-two cluster (a block's shared memory
# then keeps two to an SM, and clusters of 11 ran 1.7x slower than of 8).
# csrc/probes/quant_mma_sweep.py measured these on the H100.
_MMA_K_STEP = 16
_MMA_WARPS = 4
_QMM_MMA_TILES = {1: (4, 4, 1), 2: (8, 4, 1), 4: (4, 2, 1), 8: (2, 1, 1)}
_Q4MM_MMA_TILES = {1: (4, 4, 1), 2: (4, 4, 1), 4: (2, 2, 1), 8: (2, 1, 2)}
_MMA_SPLIT_ROWS = 256
_MMA_BLOCKS_PER_SM = 2
_MAX_SMEM = 232448  # 227 KB
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
_QMLP_MAX_SMEM = _MAX_SMEM
_QMLP_SM_SMEM = 233472  # 228 KB
_QMLP_BLOCK_RESERVED = 1024
_QMLP_MAX_THREADS = 512
# quant_mlp.cu's tensor-core route (2 <= S <= 64): 8 warps a block, at most
# one block an SM (the grid barriers need the F / block_i blocks resident
# at once); the phase-2 column tiles, in order of preference
# (csrc/probes/qmlp_mma_sweep.py); the shared-memory ring
_QMLP_MMA_WARPS = 8
_QMLP_MMA_NT = (1, 2, 4, 8)  # the kernel's n-tiles of 8 rows of x a warp
_QMLP_MMA_COLS = (128, 64)
_QMLP_MMA_STAGES = 6  # the ring's stages (NSTAGE)
_QMLP_MMA_STAGE_BYTES = 16384  # weight bytes a stage aims at
_QMLP_MMA_HEADER = 64 + 1024  # the stages' mbarriers, and room to align the ring


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


def quant_route(S: int) -> str:
    """The route of ``quant_matmul``, ``quant4_matmul`` and ``quant_mlp``
    for S rows of x: "simt" (the CUDA cores) at S = 1, "mma" (the tensor
    cores) from 2 to ``_KERNEL_MAX_ROWS``."""
    if not 1 <= S <= _KERNEL_MAX_ROWS:
        raise ValueError(f"the quant kernels take 1 <= S <= {_KERNEL_MAX_ROWS} rows, not {S} "
                         f"(qdot sends more rows to x @ dequant(w))")
    return "simt" if S == 1 else "mma"


def _qmm_geometry(D: int, F: int, sms: int):
    """quant_matmul.cu's S = 1 launch → (vec, tpr, splits, rows_per_split).
    Each thread reads ``vec`` columns (16, or 8 when F % 16 != 0) and
    ``tpr`` threads cover a tile row; the widest tile is taken whose grid
    can still reach ``_QMM_BLOCKS_PER_SM`` blocks per SM with clusters of at
    most ``_QMM_MAX_CLUSTER`` blocks, then the fewest splits of D that
    reach it (or the most allowed), at least ``_MIN_SPLIT_ROWS`` rows each.
    One cluster is the ``splits`` blocks of a column tile; every split is
    non-empty."""
    vec = 16 if F % 16 == 0 else 8
    max_splits = max(1, min(_QMM_MAX_CLUSTER, D // _MIN_SPLIT_ROWS))
    want = _QMM_BLOCKS_PER_SM * sms
    for tpr in _QMM_TPRS:
        tiles = math.ceil(F / (vec * tpr))
        if tiles * max_splits >= want:
            break
    splits = max(1, min(max_splits, math.ceil(want / tiles)))
    rows = math.ceil(math.ceil(D / splits) / 8) * 8
    return vec, tpr, math.ceil(D / rows), rows


class _MmaPlan(NamedTuple):
    """A tensor-core launch: ``mt`` m-tiles of 16 columns a warp and ``nt``
    n-tiles of 8 rows of x a block, ``wk`` of a group's 4 warps along D,
    ``wn`` groups that split the n-tiles, clusters of ``splits`` blocks over
    ``rows`` rows of D each (packed rows for int4), ``smem`` bytes of
    dynamic shared memory."""
    mt: int
    nt: int
    wk: int
    wn: int
    splits: int
    rows: int
    smem: int

    @property
    def cols(self) -> int:
        """The columns of F a block (and a cluster) covers."""
        return _MMA_WARPS // self.wk * 16 * self.mt

    def grid(self, F: int):
        """The launch's grid: the splits of a cluster along x, the column
        tiles along y; no S axis (every block carries every row of x)."""
        return self.splits, math.ceil(F / self.cols), 1


_MMA_RING = 3  # the kernels' NS: chunks of x in the ring


def _ring_bytes(mt: int, nt: int, wk: int) -> int:
    """One plane of the kernels' x ring: NS chunks of 8 nt rows of KC = 16 *
    (16 / mt) * wk bf16 values, each row padded to ``x_stride(KC)``."""
    kc = 16 * (16 // mt) * wk
    return _MMA_RING * 8 * nt * ((kc + 63) // 64 * 64 + 16) * 2


def _recv_bytes(S: int, cols: int, splits: int) -> int:
    """The cluster's partials of the 4-vectors one block finishes."""
    return splits * -(-(S * cols // 4) // splits) * 16


def _qmm_mma_smem(S: int, mt: int, nt: int, wk: int, splits: int) -> int:
    """quant_matmul.cu's ``qmm_mma_smem``: the x ring, or the warps' f32
    sums that replace it, then the cluster's partials."""
    cols = _MMA_WARPS // wk * 16 * mt
    region = max(_ring_bytes(mt, nt, wk), wk * 8 * nt * cols * 4)
    return -(-region // 16) * 16 + _recv_bytes(S, cols, splits)


def _q4mm_mma_smem(S: int, mt: int, nt: int, wk: int, splits: int) -> int:
    """quant4_matmul.cu's ``q4mm_mma_smem``: the ring of x's two halves,
    the warps' running f32 sums, then the cluster's partials."""
    cols = _MMA_WARPS // wk * 16 * mt
    return 2 * _ring_bytes(mt, nt, wk) + wk * 8 * nt * cols * 4 + _recv_bytes(S, cols, splits)


def _mma_plan(S: int, D: int, F: int, sms: int, tiles: dict, smem_of, name: str,
              packed: int = 1) -> _MmaPlan:
    """The tensor-core launch over D rows (packed rows of ``packed`` weight
    rows each for int4): ``nt`` the fewest n-tiles that hold S rows, ``mt``
    ``wk`` and ``wn`` from ``tiles`` (mt at most 4 where F % 16 != 0), then
    as many splits as keep ``_MMA_SPLIT_ROWS`` weight rows each (S > 16:
    half, and a power of two; at most 16), fewer where the grid would pass
    ``_MMA_BLOCKS_PER_SM`` blocks per SM, rows a multiple of the k-step,
    every split non-empty.  The shared memory (at most 172 KB, int4 at
    S = 64) does not depend on the split: x goes through a fixed ring."""
    if quant_route(S) != "mma":
        raise ValueError(f"{name}: the tensor-core route takes 2 <= S <= {_KERNEL_MAX_ROWS}")
    nt = next(n for n in (1, 2, 4, 8) if 8 * n >= S)
    mt, wk, wn = tiles[nt]
    if F % (2 * mt):
        mt = 4  # F % 8 == 0: 8-byte loads of 8 columns a lane
    cols = _MMA_WARPS // wk * 16 * mt
    split_rows = _MMA_SPLIT_ROWS // (2 if S > 16 else 1) // packed
    most = max(1, _MMA_BLOCKS_PER_SM * sms // math.ceil(F / cols))
    want = max(1, min(_QMM_MAX_CLUSTER, math.ceil(D / split_rows), most))
    if S > 16:
        want = 1 << (want.bit_length() - 1)
    rows = math.ceil(math.ceil(D / want) / _MMA_K_STEP) * _MMA_K_STEP
    splits = math.ceil(D / rows)
    return _MmaPlan(mt, nt, wk, wn, splits, rows, smem_of(S, mt, nt, wk, splits))


def _qmm_mma_plan(S: int, D: int, F: int, sms: int) -> _MmaPlan:
    """quant_matmul.cu's tensor-core launch (``_mma_plan`` over D)."""
    return _mma_plan(S, D, F, sms, _QMM_MMA_TILES, _qmm_mma_smem, "quant_matmul")


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# quant_matmul: x @ int8 weight
# ---------------------------------------------------------------------------


def _refuse_grad(name: str, x: torch.Tensor) -> None:
    """A quant kernel has no gradient: on the card, a call with grad enabled
    on an x that requires grad raises rather than detach silently (the JAX
    package has no quantized training path either)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise TypeError(f"{name}: the kernel has no gradient, and x requires grad; train "
                        f"dense weights and quantize them afterwards")


def quant_matmul_cluster_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                               rows_per_split: int, warps: int = 1,
                               k_step: int = _MMA_K_STEP) -> torch.Tensor:
    """The tensor-core route's order of sums as torch ops: D is cut into
    splits of ``rows_per_split`` rows (one block each); in a block, warp w
    of ``warps`` takes every ``warps``-th k-step of ``k_step`` rows from the
    w-th on and adds their f32 products in order; the warps' sums are added
    in warp order, the blocks' in rank order; × scale in f32, cast to
    x.dtype.  (Inside a k-step the tensor cores add its products in an order
    of their own.)"""
    S, D = x.shape
    xb = x.to(torch.bfloat16).float()
    qf = q.to(torch.bfloat16).float()
    total = torch.zeros((S, q.shape[1]), dtype=torch.float32, device=x.device)
    for begin in range(0, D, rows_per_split):
        end = min(D, begin + rows_per_split)
        block = torch.zeros_like(total)
        for w in range(warps):
            acc = torch.zeros_like(total)
            for a in range(begin + w * k_step, end, warps * k_step):
                acc = acc + xb[:, a:min(end, a + k_step)] @ qf[a:min(end, a + k_step)]
            block = block + acc
        total = total + block
    return (total * scale.float()).to(x.dtype)


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
    _refuse_grad("quant_matmul", x)
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
    if q.data_ptr() % 16 or scale.data_ptr() % 16:  # read as 16-byte vectors
        raise ValueError("quant_matmul: q and scale must start on a 16-byte boundary")
    y = torch.empty((S, F), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x_is_bf16 = int(x.dtype == torch.bfloat16)
    if quant_route(S) == "simt":
        vec, tpr, splits, rows = _qmm_geometry(D, F, _sms(x.device))
        launch("quant_matmul", *ptrs, S, D, F, splits, rows, tpr, vec, x_is_bf16, stream)
    else:
        p = _qmm_mma_plan(S, D, F, _sms(x.device))
        launch("quant_matmul_mma", *ptrs, S, D, F, p.splits, p.rows, p.mt, p.nt, p.wk, p.smem,
               x_is_bf16, stream)
    count_launch(quant_matmul)
    return y


quant_matmul.launches = 0


# ---------------------------------------------------------------------------
# quant4_matmul: x @ int4 weight
# ---------------------------------------------------------------------------


def _q4mm_geometry(D: int, F: int, G: int, sms: int):
    """quant4_matmul.cu's S = 1 launch → (vec, tpr, splits, rows_per_split).
    A pair of lanes reads ``vec`` columns of a packed row (16, or 8 when
    F % 16 != 0) and ``_Q4MM_TPR`` pairs cover a tile row: the narrowest
    tile, so that the fewest splits (the smallest clusters, the cheapest
    barrier) fill the card.  The grid aims at one block per
    ``_Q4MM_BYTES_PER_BLOCK`` packed bytes, held between 1 and 2 blocks per
    SM, and takes the fewest splits of the D/2 packed rows that reach it (or
    the most allowed), at least ``_MIN_SPLIT_ROWS`` rows each, in clusters
    of at most ``_QMM_MAX_CLUSTER``.  One cluster is the ``splits`` blocks
    of a column tile; every split is non-empty.  A split may cut a scale
    group of D/G packed rows or span several: the kernel scales each group
    where a block's rows leave it (``_q4mm_segments``)."""
    if G <= 0 or G % 2 or D % G:
        raise ValueError(f"quant4_matmul: G={G} must be even and divide D={D}")
    vec = 16 if F % 16 == 0 else 8
    D2 = D // 2
    tiles = math.ceil(F / (vec * _Q4MM_TPR))
    max_splits = max(1, min(_QMM_MAX_CLUSTER, D2 // _MIN_SPLIT_ROWS))
    lo, hi = (n * sms for n in _Q4MM_BLOCKS_PER_SM)
    want = min(hi, max(lo, D2 * F / _Q4MM_BYTES_PER_BLOCK))
    for want_splits in range(min(max_splits, math.ceil(want / tiles)), max_splits + 1):
        rows = math.ceil(math.ceil(D2 / want_splits) / 8) * 8
        splits = math.ceil(D2 / rows)
        if splits * tiles >= want:
            break
    return vec, _Q4MM_TPR, splits, rows


def _q4mm_mma_plan(S: int, D: int, F: int, G: int, sms: int) -> _MmaPlan:
    """quant4_matmul.cu's tensor-core launch (``_mma_plan`` over the D/2
    packed rows).  A 16-row k-step must lie in one scale group: D/G, the
    packed rows of a group, is a multiple of 16 (the trunks' G = 2 and
    128-row groups are)."""
    if G <= 0 or G % 2 or D % G or (D // G) % _MMA_K_STEP:
        raise ValueError(f"quant4_matmul: at S >= 2, G={G} must be even and divide D={D} "
                         f"into groups of a multiple of {_MMA_K_STEP} rows")
    return _mma_plan(S, D // 2, F, sms, _Q4MM_MMA_TILES, _q4mm_mma_smem, "quant4_matmul",
                     packed=2)


def _q4mm_segments(D: int, G: int, begin: int, end: int):
    """The scale groups that packed rows [begin, end) of a block touch, in
    order → [(group, first row, end row)]: every group once, cut to the
    block's rows.  Packed row d is in group d // (D/G) of each half."""
    gs = D // G
    return [(g, max(begin, g * gs), min(end, (g + 1) * gs))
            for g in range(begin // gs, (end - 1) // gs + 1)] if end > begin else []


def quant4_matmul_cluster_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor,
                                rows_per_split: int, warps: Optional[int] = None,
                                k_step: int = _MMA_K_STEP) -> torch.Tensor:
    """The kernels' order of sums as torch ops: the D/2 packed rows are cut
    into splits of ``rows_per_split`` (one block each) and the blocks' f32
    sums are added in rank order and cast to x.dtype.  A group's partial
    dots, of bf16(x)'s low half with the low nibbles and of its high half
    with the high nibbles, are scaled by the group's two scales before they
    join any sum across groups.

    Without ``warps`` (the S = 1 route) a block takes, for each group its
    rows touch (``_q4mm_segments``), the partials over its rows of the group
    into its running sum.  (The kernel scales each thread's share of a group
    and adds the shares inside the block: the same terms, f32 sums in
    another order.)  With ``warps`` (the tensor-core route) warp w of a
    block takes every ``warps``-th k-step of ``k_step`` packed rows from the
    w-th on, adds the partials of a group's k-steps in order, scales them
    into its running sum when its k-steps leave the group, and the warps'
    sums are added in warp order; a k-step never crosses a group."""
    S, D = x.shape
    G, F = scale.shape
    D2, gs = D // 2, D // G
    if warps is not None and gs % k_step:
        raise ValueError(f"a group of {gs} packed rows is not whole k-steps of {k_step}")
    lo, hi = (n.float() for n in _unpack_int4(q4))
    xb = x.to(torch.bfloat16).float()
    x_lo, x_hi = xb[:, :D2], xb[:, D2:]
    total = torch.zeros((S, F), dtype=torch.float32, device=x.device)

    def scaled(group, p_lo, p_hi):
        return p_lo * scale[group].float() + p_hi * scale[G // 2 + group].float()

    for begin in range(0, D2, rows_per_split):
        end = min(D2, begin + rows_per_split)
        block = torch.zeros_like(total)
        if warps is None:
            for g, a, b in _q4mm_segments(D, G, begin, end):
                block = block + scaled(g, x_lo[:, a:b] @ lo[a:b], x_hi[:, a:b] @ hi[a:b])
        for w in range(warps or 0):
            run, p_lo, p_hi = (torch.zeros_like(total) for _ in range(3))
            group = begin // gs
            for a in range(begin + w * k_step, end, warps * k_step):
                b = min(end, a + k_step)
                if a // gs != group:
                    run = run + scaled(group, p_lo, p_hi)
                    p_lo, p_hi = torch.zeros_like(total), torch.zeros_like(total)
                    group = a // gs
                p_lo = p_lo + x_lo[:, a:b] @ lo[a:b]
                p_hi = p_hi + x_hi[:, a:b] @ hi[a:b]
            block = block + (run + scaled(group, p_lo, p_hi))
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
    _refuse_grad("quant4_matmul", x)
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
    y = torch.empty((S, F), dtype=torch.bfloat16, device=x.device)
    ptrs = (x.data_ptr(), q4.data_ptr(), scale.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if quant_route(S) == "simt":
        vec, tpr, splits, rows = _q4mm_geometry(D, F, G, _sms(x.device))
        launch("quant4_matmul", *ptrs, S, D, F, G, splits, rows, tpr, vec, stream)
    else:
        p = _q4mm_mma_plan(S, D, F, G, _sms(x.device))
        launch("quant4_matmul_mma", *ptrs, S, D, F, G, p.splits, p.rows, p.mt, p.nt, p.wk,
               p.wn, p.smem, stream)
    count_launch(quant4_matmul)
    return y


quant4_matmul.launches = 0


# ---------------------------------------------------------------------------
# quant_mlp: the fused int8 SwiGLU MLP
# ---------------------------------------------------------------------------


def _qmlp_smem_bytes(block_i: int, Dout: int, threads: int, cluster: int,
                     prefetch_rows: int) -> int:
    """quant_mlp.cu's ``layout(...).total`` (the S = 1 route): the mbarrier,
    the prefetched w2 rows, h, the larger of the phase-1 warp sums and the
    phase-2 slice sums, and the cluster's receive slots."""
    rg2 = min(max(1, threads // (Dout // 8)), block_i)
    slice_ = -(-(Dout // 4) // cluster) * 4
    return (16 + -(-prefetch_rows * Dout // 16) * 16 + block_i * 4
            + max(threads // 32 * 2 * block_i * 4, rg2 * Dout * 4) + cluster * slice_ * 4)


def _qmlp_geometry(S: int, D: int, F: int, Dout: int, sms: int):
    """quant_mlp.cu's S = 1 launch (the CUDA-core route) → (block_i,
    cluster, threads, prefetch_rows, smem).  The widest tile whose F /
    block_i blocks still reach every SM (else the narrowest), k =
    ceil(blocks / SMs) blocks per SM of 512 / k threads (at most 8 *
    block_i: 64 row groups), and the largest cluster that divides the grid
    and whose clusters the card holds at once with k blocks per SM
    (``_QMLP_CLUSTER_SLOTS``, scaled to ``sms``): one wave.  The w2 tile is
    prefetched whole where a block's share of the SM's shared memory holds
    it, else its first rows (an even count), and ``smem`` asks for enough
    shared memory that no (k+1)-th block fits on an SM.  D does not enter:
    x is not staged."""
    if quant_route(S) != "simt" or F % _QMLP_TILES[-1] or Dout % 8:
        raise ValueError(f"quant_mlp: the CUDA-core route takes S = 1, F % {_QMLP_TILES[-1]} "
                         f"== 0 and Dout % 8 == 0 (S={S}, F={F}, Dout={Dout})")
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
    while rows > 0 and _qmlp_smem_bytes(block_i, Dout, threads, cluster, rows) > budget:
        rows -= 2
    need = _qmlp_smem_bytes(block_i, Dout, threads, cluster, rows)
    if need > budget:
        raise ValueError(f"quant_mlp: Dout={Dout} needs more shared memory than a block has")
    spread = _QMLP_SM_SMEM // (per_sm + 1) - _QMLP_BLOCK_RESERVED + 16
    return block_i, cluster, threads, rows, min(budget, max(need, spread))


class _QmlpPlan(NamedTuple):
    """A launch of quant_mlp.cu's tensor-core route: ``nt`` n-tiles of 8
    rows of x a warp; F / ``block_i`` blocks, each
    walking its intermediate tile in passes of ``pass_cols`` columns (phase
    1); phase 2's column tiles of ``cols`` columns of Dout, each over
    ``splits`` row ranges of ``rows`` rows of F; ``kc1`` / ``kc2`` rows of
    the reduction a stage of the shared-memory ring holds in phase 1 / 2;
    ``smem`` bytes of dynamic shared memory."""
    nt: int
    block_i: int
    pass_cols: int
    cols: int
    rows: int
    splits: int
    kc1: int
    kc2: int
    smem: int

    @property
    def wk1(self) -> int:
        """Phase 1's warps along D."""
        return _QMLP_MMA_WARPS // (self.pass_cols // 32)

    @property
    def wk2(self) -> int:
        """Phase 2's warps along F."""
        return _QMLP_MMA_WARPS // (self.cols // 64)


def _qmlp_stage_bytes(kc: int, rb: int, sp: int) -> int:
    """quant_mlp.cu's ``stage_bytes``: kc weight rows of rb bytes (dense,
    swizzled), then sp activation rows of kc bf16 padded to 16 (mod 128)
    bytes, rounded up to the swizzle's 1024-byte period."""
    return kc * rb + -(-sp * ((kc + 63) // 64 * 64 + 8) * 2 // 1024) * 1024


def _qmlp_mma_smem(nt: int, pass_cols: int, cols: int, kc1: int, kc2: int) -> int:
    """quant_mlp.cu's ``mma_smem``: the ring stages' mbarriers (64 bytes)
    and 1024 to align the region, then the larger of either phase's ring
    (``_QMLP_MMA_STAGES`` stages) and its warps' f32 sums, which replace the
    ring after the phase's products."""
    sp = 8 * nt
    wk1 = _QMLP_MMA_WARPS // (pass_cols // 32)
    wk2 = _QMLP_MMA_WARPS // (cols // 64)
    return _QMLP_MMA_HEADER + max(
        _QMLP_MMA_STAGES * _qmlp_stage_bytes(kc1, 2 * pass_cols, sp),
        wk1 * sp * 2 * pass_cols * 4,
        _QMLP_MMA_STAGES * _qmlp_stage_bytes(kc2, cols, sp), wk2 * sp * cols * 4)


def _qmlp_stage_rows(wk: int, rb: int, sp: int) -> Optional[int]:
    """Rows of the reduction a ring stage holds: the most of 256, 128, 64,
    32, 16 that is whole k-steps of every warp along it (16 * wk), keeps a
    stage's weight bytes within ``_QMLP_MMA_STAGE_BYTES`` and the ring
    within a block's shared memory; None if none does."""
    fits = [kc for kc in (256, 128, 64, 32, 16) if kc % (16 * wk) == 0
            and _QMLP_MMA_HEADER + _QMLP_MMA_STAGES * _qmlp_stage_bytes(kc, rb, sp) <= _MAX_SMEM]
    return next((kc for kc in fits if kc * rb <= _QMLP_MMA_STAGE_BYTES), fits[-1] if fits else None)


def _qmlp_mma_plan(S: int, D: int, F: int, Dout: int, sms: int,
                   block_i: Optional[int] = None, cols: Optional[int] = None) -> _QmlpPlan:
    """quant_mlp.cu's tensor-core launch for 2 <= S <= 64.  ``nt`` the
    fewest n-tiles (a power of two) that hold S rows, every warp over all of
    them; ``block_i`` (unless given) the narrowest tile of whole 32-column
    groups whose F / block_i blocks fit one to an SM; the widest pass (1, 2
    or 4 warps of 32 columns); then the first of ``_QMLP_MMA_COLS`` (or
    ``cols``) whose column tiles leave each at least one split of the grid,
    with as many splits of F as the blocks hold, rows a multiple of 16,
    every split non-empty; the ring's stage rows by ``_qmlp_stage_rows``.
    ``smem`` asks for enough shared memory that no second block fits on an
    SM, so the blocks spread over the SMs."""
    if quant_route(S) != "mma":
        raise ValueError(f"quant_mlp: the tensor-core route takes 2 <= S <= {_KERNEL_MAX_ROWS}")
    if D % 16 or F % 32 or Dout % 8:
        raise ValueError(f"quant_mlp: at S >= 2 need D % 16 == 0, F % 32 == 0 and Dout % 8 == 0 "
                         f"(D={D}, F={F}, Dout={Dout})")
    nt = next(n for n in _QMLP_MMA_NT if 8 * n >= S)
    if block_i is None:
        block_i = next((b for b in range(32, F + 1, 32) if F % b == 0 and F // b <= sms), None)
    if block_i is None or block_i % 32 or F % block_i:
        raise ValueError(f"quant_mlp: no tile of whole 32-column groups divides F={F} into at "
                         f"most {sms} blocks")
    blocks = F // block_i
    spread = _QMLP_SM_SMEM // 2 - _QMLP_BLOCK_RESERVED + 16
    wc = next(w for w in (4, 2, 1) if block_i % (32 * w) == 0)
    kc1 = _qmlp_stage_rows(_QMLP_MMA_WARPS // wc, 64 * wc, 8 * nt)
    for c in (cols,) if cols else _QMLP_MMA_COLS:
        tiles = -(-Dout // c)
        kc2 = _qmlp_stage_rows(_QMLP_MMA_WARPS // (c // 64), c, 8 * nt)
        if tiles > blocks or kc1 is None or kc2 is None:
            continue
        rows = -(-F // (blocks // tiles) // 16) * 16
        need = _qmlp_mma_smem(nt, 32 * wc, c, kc1, kc2)
        if need <= _MAX_SMEM:
            return _QmlpPlan(nt, block_i, 32 * wc, c, rows, -(-F // rows), kc1, kc2,
                             max(need, spread))
    raise ValueError(f"quant_mlp: no column tile fits Dout={Dout} at F={F}, S={S}")


def _qmlp_mma_parts(S: int, Dout: int, plan: _QmlpPlan) -> int:
    """f32 elements of a tensor-core call's split partials, (splits, S, Dout),
    rounded up to 16 bytes: h (S, F) bf16 follows them in the buffer."""
    return -(-plan.splits * S * Dout // 4) * 4


@functools.lru_cache(maxsize=None)
def _qmlp_numel(D: int, F: int, Dout: int, sms: int) -> int:
    """f32 elements of the per-stream buffer every call of this shape fits
    in, whatever its S: the S = 1 route's cluster partials, or the
    tensor-core route's split partials and h at the most rows of each
    n-tile count.  So a stream whose first call of a shape ran eagerly at any
    S may capture that shape at any other."""
    need = 0
    for S in (1, 8, 16, 32, 64):
        try:
            if S == 1:
                need = max(need, _qmlp_parts(F, Dout, *_qmlp_geometry(1, D, F, Dout, sms)[:2]))
            else:
                plan = _qmlp_mma_plan(S, D, F, Dout, sms)
                need = max(need, _qmlp_mma_parts(S, Dout, plan) + -(-S * F // 2))
        except ValueError:
            continue
    return need


def _qmlp_parts(F: int, Dout: int, block_i: int, cluster: int) -> int:
    """f32 elements of the cluster partials an S = 1 call keeps: F /
    block_i / cluster partials of Dout."""
    return F // block_i // cluster * Dout


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


def quant_mlp_mma_plain(x: torch.Tensor, q13: torch.Tensor, s13: torch.Tensor,
                        q2: torch.Tensor, s2: torch.Tensor, plan: _QmlpPlan) -> torch.Tensor:
    """The tensor-core route's order of sums as torch ops.  Phase 1: warp w
    of ``plan.wk1`` takes every wk1-th 16-row k-step of D from the w-th and
    adds their f32 products in order, the warps' sums in warp order, × s13,
    rounded to bf16; h = bf16(bf16(silu(a1)) · a3).  Phase 2: F is cut into
    splits of ``plan.rows`` rows; in each, warp w of ``plan.wk2`` takes every
    wk2-th k-step of the split from the w-th, the warps' sums in warp order;
    the splits' partials are added in split order, × s2, cast to x.dtype.
    (Inside a k-step the tensor cores add its products in an order of their
    own.)"""
    F = q13.shape[1] // 2
    a = quant_matmul_cluster_plain(x.to(torch.bfloat16), q13, s13, x.shape[1], plan.wk1)
    h = F_.silu(a[:, :F].float()).to(torch.bfloat16) * a[:, F:]
    return quant_matmul_cluster_plain(h, q2, s2, plan.rows, plan.wk2).to(x.dtype)


def quant_mlp(x: torch.Tensor, q13: torch.Tensor, s13: torch.Tensor, q2: torch.Tensor,
              s2: torch.Tensor) -> torch.Tensor:
    """silu(x@W1)·(x@W3) @ W2 with all three weights int8, one kernel:
    x (S, D) bf16; q13 (D, 2F) int8 (w1 columns [:F], w3 [F:]); s13 (2F,)
    f32; q2 (F, Dout) int8; s2 (Dout,) f32 → (S, Dout) bf16.  CUDA tensors
    launch the kernel's route for S (``quant_route``: the S = 1 geometry
    ``_qmlp_geometry`` or the tensor-core plan ``_qmlp_mma_plan``), or
    raise; CPU tensors run ``quant_mlp_plain``.  ``quant_mlp.launches``
    counts launches."""
    if x.device.type == "cpu":
        return quant_mlp_plain(x, q13, s13, q2, s2)
    if x.device.type != "cuda":
        raise ValueError(f"quant_mlp: unsupported device {x.device}")
    _refuse_grad("quant_mlp", x)
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
    sms = _sms(x.device)
    if quant_route(S) == "simt":
        geometry = _qmlp_geometry(S, D, F, Dout, sms)
        need = _qmlp_parts(F, Dout, *geometry[:2])
    else:
        p = _qmlp_mma_plan(S, D, F, Dout, sms)
        parts = _qmlp_mma_parts(S, Dout, p)
        need = parts + -(-S * F // 2)  # the split partials, then h
    part, barrier = _qmlp_workspace(x.device, max(_qmlp_numel(D, F, Dout, sms), need))
    y = torch.empty((S, Dout), dtype=torch.bfloat16, device=x.device)
    ptrs = (x.data_ptr(), q13.data_ptr(), s13.data_ptr(), q2.data_ptr(), s2.data_ptr(),
            y.data_ptr(), part.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if quant_route(S) == "simt":
        launch("quant_mlp", *ptrs, barrier.data_ptr(), D, F, Dout, *geometry, stream)
    else:
        launch("quant_mlp_mma", *ptrs, part.data_ptr() + 4 * parts, barrier.data_ptr(), S, D, F,
               Dout, p.block_i, p.pass_cols, p.nt, p.cols, p.rows, p.splits, p.kc1, p.kc2, p.smem,
               stream)
    count_launch(quant_mlp)
    return y


quant_mlp.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


# the most rows a quantized product sends to its kernel on the card; more
# rows (a serving pool of more than 64 slots) are compute-bound and take
# x @ dequant(w), as the JAX package's qdot routes them
_KERNEL_MAX_ROWS = 64


def routes_to_kernel(device_type: str, rows: int) -> bool:
    """Whether ``qdot`` sends a quantized product of ``rows`` rows on a
    ``device_type`` tensor to its kernel."""
    return device_type == "cuda" and rows <= _KERNEL_MAX_ROWS


def qdot(x: torch.Tensor, w: Union[torch.Tensor, dict]) -> torch.Tensor:
    """Matmul against a maybe-quantized weight. x: (..., in); w: (in, out)
    tensor, int8 dict or int4 dict.

    On the card a quantized product of at most 64 rows goes to its kernel
    (an int4 one with x cast to bf16 and the result cast back).  Otherwise
    it is the JAX package's dequant branch, ``x @ dequant(w, x.dtype)``:
    every product on the CPU, so the CPU tests compare like with like, and
    on the card the compute-bound products of more rows.

    Precision contract (as in the JAX package): the kernels compute bf16
    activations × bf16-dequantized weights with f32 accumulation; an f32
    caller gets f32 back, not f32 dot precision.
    """
    if not (is_quantized4(w) or is_quantized(w)):
        return x @ w
    lead, D = x.shape[:-1], x.shape[-1]
    if not routes_to_kernel(x.device.type, x.numel() // D):
        return x @ (_dequant4(w, x.dtype) if is_quantized4(w) else _dequant(w, x.dtype))
    if is_quantized4(w):
        out = quant4_matmul(x.reshape(-1, D).to(torch.bfloat16).contiguous(),
                            w["q4"], w["scale"])
        return out.reshape(*lead, out.shape[-1]).to(x.dtype)
    out = quant_matmul(x.reshape(-1, D).contiguous(), w["q"], w["scale"])
    return out.reshape(*lead, out.shape[-1])


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
# a hybrid trunk's (models/hybrid.py) further products: the conv layers'
# projections and the stacked experts; its conv taps, norms, router and
# expert bias stay in the model dtype
_HYBRID_QUANT_KEYS = ("in_proj", "out_proj", "experts_w13", "experts_w2")


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
    """Quantize qkv, o_proj, w13 and w2 of every layer (and a hybrid
    trunk's in_proj, out_proj and experts, where a layer has them):
    per-channel int8 (``bits=8``; an expert stack (E, in, out) one scale a
    column of each expert) or group-wise int4 (``bits=4``, dense products
    only) with half-matrix groups (``group = in_dim // 2``) unless ``group``
    is given."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: only int8 (8) and int4 (4) are supported")
    layers = []
    for wl in trunk_params["layers"]:
        wl = dict(wl)
        for k in _TRUNK_QUANT_KEYS + _HYBRID_QUANT_KEYS:
            if k not in wl:
                continue
            w = wl[k]
            if bits == 4 and w.dim() != 2:
                raise NotImplementedError(f"int4 {k}: only dense (in, out) products have an "
                                          f"int4 kernel; quantize the experts to int8")
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

"""The routed FFN of a mixture-of-experts layer (LFM2-MoE's), and its kernel.

``route`` is LFM2-MoE's router: scores σ(x·W_gate) in f32; the expert
bias, where there is one, is added to the scores only to choose the top
k; the chosen σ scores are divided by their sum + 1e-6 (``norm_topk_prob``)
and times ``routed_scaling_factor``.  No expert is shared.

``moe_ffn`` runs the routed SwiGLU over the chosen experts, every token
kept:

- int8 experts go to ``expert_swiglu``: on a CUDA tensor the kernel
  ``csrc/expert_swiglu.cu`` (routing read from device memory, so a CUDA
  graph can hold it), in chunks of at most 64 rows, or an error beyond
  its limits; on a CPU tensor its plain version ``expert_swiglu_plain``;
- unquantized experts (the bf16 prefill shadow, an f32 model) run every
  expert over every row and weight the results by the routing, zero for
  an expert a row did not choose (``moe_ffn_dense``): no host sync and no
  shape that depends on the routing, at 32/4 times the operations of the
  chosen experts alone, which a compute-bound prefill affords.

Both add a row's expert outputs in a fixed order, so the result does not
depend on the schedule.  ``stats`` (int32 [2], on the rows' device) takes
the step's counters: [0] += the experts with at least one row, [1] = the
most rows any expert took, if more.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F_

from sesameai_tts_tpu_torch.ops.kernels import check_operands, count_launch, launch
from sesameai_tts_tpu_torch.ops.quant import _dequant, _refuse_grad, is_quantized, qmlp

_KERNEL_MAX_ROWS = 64
_KERNEL_MAX_TOPK = 8


def route(x: torch.Tensor, gate: torch.Tensor, bias: Optional[torch.Tensor], k: int,
          norm_topk_prob: bool = True,
          scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D) and W_gate (D, E) → (ids (N, k) int64, weights (N, k) f32):
    the k experts of highest σ(x·W_gate) (+ ``bias``, for the choice only),
    best first, and their σ scores (module docstring)."""
    scores = torch.sigmoid(x.float() @ gate.float())
    choose = scores if bias is None else scores + bias.float()
    ids = choose.topk(k, dim=-1).indices
    weights = scores.gather(-1, ids)
    if norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-6)
    return ids, weights * scaling


def _record(stats: Optional[torch.Tensor], ids: torch.Tensor, experts: int) -> None:
    """``stats`` [0] += experts hit, [1] = max(itself, most rows an expert
    took); no host sync, so a CUDA graph can hold it."""
    if stats is None:
        return
    flat = ids.reshape(-1)
    counts = torch.zeros(experts, dtype=torch.int32, device=ids.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    stats[0] += (counts > 0).sum().to(stats.dtype)
    torch.maximum(stats[1], counts.max().to(stats.dtype), out=stats[1])


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """(N, k, D) → (N, D): part 0 + part 1 + ... in that order."""
    out = parts[:, 0]
    for j in range(1, parts.shape[1]):
        out = out + parts[:, j]
    return out


def expert_swiglu_plain(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                        q13: torch.Tensor, s13: torch.Tensor, q2: torch.Tensor,
                        s2: torch.Tensor, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic as torch ops: for each pair (row n, choice
    j) routed to expert e, a = (bf16(x[n]) @ q13[e]) × s13[e] in f32, h =
    silu(a1) · a3 in f32, part = (h @ q2[e]) × s2[e] × weights[n, j]; y[n]
    = part[n, 0] + part[n, 1] + ... in that order, cast to x.dtype.  The
    kernel adds each product's terms in an order of its own."""
    N, D = x.shape
    k = ids.shape[1]
    E, _, F2 = q13.shape
    Fi = F2 // 2
    xb = x.to(torch.bfloat16).float()
    flat, w = ids.reshape(-1), weights.reshape(-1).float()
    parts = torch.zeros((N * k, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        pairs = (flat == e).nonzero()[:, 0]
        if pairs.numel() == 0:
            continue
        a = (xb[pairs // k] @ q13[e].float()) * s13[e].float()
        h = F_.silu(a[:, :Fi]) * a[:, Fi:]
        parts[pairs] = (h @ q2[e].float()) * s2[e].float() * w[pairs, None]
    _record(stats, ids, E)
    return _sum_in_order(parts.view(N, k, D)).to(x.dtype)


def expert_swiglu(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor, q13: torch.Tensor,
                  s13: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
                  stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_j weights[n, j] · SwiGLU_e(x[n]) over the experts e = ids[n, j]
    of int8 experts q13 (E, D, 2F) with s13 (E, 2F) and q2 (E, F, D) with
    s2 (E, D), for x (N, D) bf16 (N ≤ 64), ids (N, k) int64 and weights
    (N, k) f32 → (N, D) bf16; ``stats`` as the module docstring says.
    CUDA tensors launch ``csrc/expert_swiglu.cu`` (three kernels: the up
    projection with the SwiGLU, the down projection, the ordered sum) or
    raise; CPU tensors run ``expert_swiglu_plain``.
    ``expert_swiglu.launches`` counts the kernels launched."""
    if x.device.type == "cpu":
        return expert_swiglu_plain(x, ids, weights, q13, s13, q2, s2, stats)
    if x.device.type != "cuda":
        raise ValueError(f"expert_swiglu: unsupported device {x.device}")
    _refuse_grad("expert_swiglu", x)
    if x.dim() != 2 or ids.dim() != 2 or q13.dim() != 3 or q2.dim() != 3:
        raise ValueError(f"expert_swiglu: want x (N, D), ids (N, k), q13 (E, D, 2F), q2 "
                         f"(E, F, D); got {tuple(x.shape)}, {tuple(ids.shape)}, "
                         f"{tuple(q13.shape)}, {tuple(q2.shape)}")
    N, D = x.shape
    k = ids.shape[1]
    E, _, F2 = q13.shape
    Fi = F2 // 2
    if (q13.shape != (E, D, 2 * Fi) or q2.shape != (E, Fi, D) or s13.shape != (E, 2 * Fi)
            or s2.shape != (E, D) or ids.shape[0] != N or weights.shape != ids.shape):
        raise ValueError(f"expert_swiglu: shape mismatch x {tuple(x.shape)}, ids "
                         f"{tuple(ids.shape)}, weights {tuple(weights.shape)}, q13 "
                         f"{tuple(q13.shape)}, s13 {tuple(s13.shape)}, q2 {tuple(q2.shape)}, "
                         f"s2 {tuple(s2.shape)}")
    if (x.dtype != torch.bfloat16 or ids.dtype != torch.int64 or weights.dtype != torch.float32
            or q13.dtype != torch.int8 or q2.dtype != torch.int8
            or s13.dtype != torch.float32 or s2.dtype != torch.float32):
        raise TypeError(f"expert_swiglu: want x bf16, ids int64, weights f32, q int8, scales "
                        f"f32; got {x.dtype}, {ids.dtype}, {weights.dtype}, {q13.dtype}, "
                        f"{s13.dtype}, {q2.dtype}, {s2.dtype}")
    if not (1 <= N <= _KERNEL_MAX_ROWS and 1 <= k <= _KERNEL_MAX_TOPK and D % 128 == 0
            and Fi % 64 == 0):
        raise ValueError(f"expert_swiglu: need 1 <= N <= {_KERNEL_MAX_ROWS}, 1 <= k <= "
                         f"{_KERNEL_MAX_TOPK}, D % 128 == 0 and F % 64 == 0 (N={N}, k={k}, "
                         f"D={D}, F={Fi})")
    tensors = {"x": x, "ids": ids, "weights": weights, "q13": q13, "s13": s13, "q2": q2,
               "s2": s2}
    if stats is not None:
        if stats.dtype != torch.int32 or stats.shape != (2,):
            raise TypeError(f"expert_swiglu: want stats int32 (2,); got {stats.dtype} "
                            f"{tuple(stats.shape)}")
        tensors["stats"] = stats
    check_operands("expert_swiglu", tensors, x.device)
    if q13.data_ptr() % 16 or q2.data_ptr() % 16:  # read as 16-byte vectors
        raise ValueError("expert_swiglu: q13 and q2 must start on a 16-byte boundary")
    h = torch.empty((N * k, Fi), dtype=torch.float32, device=x.device)
    parts = torch.empty((N * k, D), dtype=torch.float32, device=x.device)
    y = torch.empty((N, D), dtype=torch.bfloat16, device=x.device)
    launch("expert_swiglu", x.data_ptr(), ids.data_ptr(), weights.data_ptr(), q13.data_ptr(),
           s13.data_ptr(), q2.data_ptr(), s2.data_ptr(), h.data_ptr(), parts.data_ptr(),
           y.data_ptr(), None if stats is None else stats.data_ptr(), N, k, E, D, Fi,
           torch.cuda.current_stream(x.device).cuda_stream)
    count_launch(expert_swiglu, 3)
    return y


expert_swiglu.launches = 0


def _expert(w: Union[torch.Tensor, dict], e: int) -> Union[torch.Tensor, dict]:
    """Expert ``e``'s slice of a stacked (E, in, out) weight, dense or int8."""
    if is_quantized(w):
        return {"q": w["q"][e], "scale": w["scale"][e]}
    return w[e]


def moe_ffn_dense(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                  w13: Union[torch.Tensor, dict], w2: Union[torch.Tensor, dict],
                  stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every expert's SwiGLU over every row of x (N, D) (``qmlp``, int8
    experts dequantized to x's dtype), each weighted by the row's routing
    weight for it in f32 (0 where the row did not choose it) and added in
    expert order → (N, D) in x.dtype."""
    N, _ = x.shape
    experts = (w13["q"] if is_quantized(w13) else w13).shape[0]
    dense = torch.zeros((N, experts), dtype=torch.float32, device=x.device)
    dense.scatter_(1, ids, weights.float())
    out = None
    for e in range(experts):
        y13, y2 = _expert(w13, e), _expert(w2, e)
        if is_quantized(y13):
            y13, y2 = _dequant(y13, x.dtype), _dequant(y2, x.dtype)
        part = qmlp(x, y13, y2).float() * dense[:, e:e + 1]
        out = part if out is None else out + part
    _record(stats, ids, experts)
    return out.to(x.dtype)


def moe_ffn(x: torch.Tensor, wl: dict, cfg, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed FFN of a layer's params ``wl`` ("router" (D, E),
    "expert_bias" (E,), "experts_w13" (E, D, 2F), "experts_w2" (E, F, D))
    for x (..., D) under the trunk configuration ``cfg`` (module
    docstring)."""
    lead, D = x.shape[:-1], x.shape[-1]
    xs = x.reshape(-1, D)
    ids, weights = route(xs, wl["router"], wl["expert_bias"] if cfg.use_expert_bias else None,
                         cfg.num_experts_per_tok, cfg.norm_topk_prob, cfg.routed_scaling_factor)
    w13, w2 = wl["experts_w13"], wl["experts_w2"]
    if not (is_quantized(w13) and is_quantized(w2)):
        return moe_ffn_dense(xs, ids, weights, w13, w2, stats).reshape(*lead, D)
    xb, weights = xs.to(torch.bfloat16).contiguous(), weights.contiguous()
    operands = (w13["q"], w13["scale"], w2["q"], w2["scale"])
    N = xs.shape[0]
    if xs.device.type == "cpu" or N <= _KERNEL_MAX_ROWS:
        y = expert_swiglu(xb, ids, weights, *operands, stats)
    else:  # the kernel's rows at a time; the counters over all of them
        y = torch.cat([expert_swiglu(xb[i:i + _KERNEL_MAX_ROWS], ids[i:i + _KERNEL_MAX_ROWS],
                                     weights[i:i + _KERNEL_MAX_ROWS], *operands)
                       for i in range(0, N, _KERNEL_MAX_ROWS)])
        _record(stats, ids, w13["q"].shape[0])
    return y.to(x.dtype).reshape(*lead, D)

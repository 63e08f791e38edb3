"""CSM training objective (port of ``sesameai_tts_tpu/training/loss.py``).

Next-frame prediction over interleaved text/audio rows:

* **codebook-0 loss**: the backbone's hidden state at row t →
  ``codebook0_head`` → cross-entropy against row t+1's codebook-0 token,
  over rows whose successor is an audio frame;
* **decoder loss**: for ``decoder_frames`` audio rows per example (the
  published recipe trains the decoder on a subset of frames), the decoder
  runs teacher-forced over [h_t, embed(c0..c_{K-2})] at positions 0..K-1 and
  position i ≥ 1 predicts codebook i through ``audio_head[i-1]``.

Shapes are fixed: the subset is chosen by a stable argsort of a rank key
(the first audio rows, or the smallest of the step's ``subset_r`` scores),
with zero weight where an example has fewer audio rows.  The logits of
both heads are f32.

On a mesh (``parallel/``) the params are this rank's tp shards (``tp``)
and the batch its dp rows (``dp``).  Each loss divides by the GLOBAL
batch's count (the two counts summed over ``dp``, detached), as the JAX
package's mean over its dp-sharded batch does: a rank's loss is then its
share of the global mean and the global gradient is the sum of the ranks'.
The metrics are the global losses, on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from sesameai_tts_tpu_torch.core.config import CSMConfig
from sesameai_tts_tpu_torch.models.csm import embed_frames, lookup
from sesameai_tts_tpu_torch.models.transformer import precompute_rope, transformer_forward


class Batch(NamedTuple):
    tokens: torch.Tensor  # (B, S, K+1) int
    mask: torch.Tensor  # (B, S, K+1) bool
    loss_mask: torch.Tensor  # (B, S) bool — rows that are real (not padding)


def _softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


def csm_loss(
    params: dict,
    cfg: CSMConfig,
    batch: Batch,
    decoder_frames: int = 4,
    remat: bool = False,
    subset_r: Optional[torch.Tensor] = None,
    tp: Optional[dist.ProcessGroup] = None,
    dp: Optional[dist.ProcessGroup] = None,
):
    """→ (scalar loss, {"loss", "c0_loss", "decoder_loss"}).

    ``subset_r``: optional (B, S-1) uniform scores ranking which audio rows
    the decoder loss trains (smallest win); ``None`` takes the first
    ``decoder_frames`` audio rows (eval).  ``remat`` recomputes the
    backbone's layers in the backward pass.  ``tp`` and ``dp``: the mesh's
    groups (module docstring); with ``dp`` the returned loss is this rank's
    share and the metrics the global values."""
    bb, dec = cfg.backbone, cfg.decoder
    if bb.kind != "llama":
        raise NotImplementedError(f"training covers Llama backbones; {cfg.backbone_flavor!r} "
                                  f"is a {bb.kind} trunk")
    K = cfg.audio_num_codebooks
    tokens = batch.tokens.long()
    B, S, _ = tokens.shape
    dev = tokens.device

    x = embed_frames(params, cfg, tokens, batch.mask, tp=tp).to(params["projection"].dtype)
    h, _ = transformer_forward(params["backbone"], bb, x, torch.zeros(B, dtype=torch.int64,
                                                                    device=dev), None,
                               precompute_rope(bb, device=dev), remat=remat, tp=tp)

    is_audio = batch.mask[..., 0] & batch.loss_mask  # rows carrying audio codes

    # ---- codebook-0 loss: h[t] predicts row t+1's c0 where t+1 is audio
    c0_logits = h[:, :-1].float() @ params["codebook0_head"].float()
    c0_w = is_audio[:, 1:].float()
    c0_xent = _softmax_xent(c0_logits, tokens[:, 1:, 0]) * c0_w

    # ---- decoder loss on a subset of audio rows: audio rows rank first (by
    # position, or by subset_r's scores), then the first `decoder_frames`
    pos = torch.arange(S - 1, device=dev)[None, :]
    if subset_r is None:
        rank_key = torch.where(is_audio[:, 1:], pos, S + pos)
    else:
        # scores in [0, 1); non-audio rows rank strictly after (≥ 2)
        rank_key = torch.where(is_audio[:, 1:], subset_r.float(), 2.0 + pos.float())
    sel = torch.argsort(rank_key, dim=1, stable=True)[:, :decoder_frames]  # (B, n)
    n = sel.shape[1]
    sel_w = torch.gather(is_audio[:, 1:], 1, sel).float()

    h_sel = torch.gather(h[:, :-1], 1, sel[..., None].expand(B, n, h.shape[-1]))  # (B, n, D)
    tgt_codes = torch.gather(tokens[:, 1:, :K], 1, sel[..., None].expand(B, n, K))  # (B, n, K)

    # teacher-forced decoder inputs: [proj(h), proj(embed(c0..c_{K-2}))]
    offs = torch.arange(K - 1, device=dev) * cfg.audio_vocab_size
    emb = lookup(params["audio_embeddings"], tgt_codes[..., : K - 1] + offs,
                 cfg.audio_vocab_size * K, tp)  # (B, n, K-1, D)
    dec_in = torch.cat([h_sel[:, :, None, :], emb], dim=2)  # (B, n, K, D)
    dec_in = (dec_in @ params["projection"]).to(params["projection"].dtype)
    dec_in = dec_in.reshape(B * n, K, dec.embed_dim)

    dh, _ = transformer_forward(params["decoder"], dec, dec_in,
                                torch.zeros(B * n, dtype=torch.int64, device=dev), None,
                                precompute_rope(dec, max_len=K, device=dev),
                                tp=tp)  # positions 0..K-1
    dh = dh.reshape(B, n, K, dec.embed_dim)[:, :, 1:, :]  # positions 1..K-1

    dec_logits = torch.einsum("bnkd,kdv->bnkv", dh.float(), params["audio_head"].float())
    dec_xent = _softmax_xent(dec_logits, tgt_codes[..., 1:])  # (B, n, K-1)

    counts = torch.stack([c0_w.sum(), sel_w.sum()])
    if dp is not None:  # the global batch's counts
        dist.all_reduce(counts, group=dp)
    c0_loss = c0_xent.sum() / torch.clamp_min(counts[0], 1.0)
    dec_loss = (dec_xent * sel_w[..., None]).sum() / torch.clamp_min(counts[1] * (K - 1), 1.0)
    loss = c0_loss + dec_loss
    if dp is None:
        return loss, {"loss": loss, "c0_loss": c0_loss, "decoder_loss": dec_loss}
    parts = torch.stack([c0_loss, dec_loss]).detach()
    dist.all_reduce(parts, group=dp)
    return loss, {"loss": parts[0] + parts[1], "c0_loss": parts[0], "decoder_loss": parts[1]}

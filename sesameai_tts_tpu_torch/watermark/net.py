"""The silentcipher watermark network at 44.1 kHz (port of
``sesameai_tts_tpu/watermark/net.py``).

The reference marks every utterance with sony/silentcipher's learned
encoder and decoder.  This module is that network in torch, plus the
converter of silentcipher's torch checkpoints: with one,
``load_watermarker(ckpt_path=...)`` (``watermark/api.py``) marks with the
learned network; without one the DSP scheme (``watermark/dsp.py``) stays
the default.

Topology, as the JAX package reconstructs it from the public release:

  enc_c : conv stack on the carrier magnitude STFT (B,1,F,T) → (B,C,F,T)
  enc_m : per-byte embedding table (256, F) tiled across time
  dec_c : conv stack on concat(mag, enc_c(mag), message channels) →
          (B,1,F,T), an additive magnitude-domain residual
  dec_m : conv stack(s) on mag → per-byte logits over 256 per frame

  encode: ``y = x + α·istft(resid·e^{iφ})``, α in closed form for the
          target message SDR (the iSTFT is linear in the residual at a
          fixed phase, so the SDR is exact);
  decode: per-byte softmax over 256 averaged across frames → argmax;
          confidence = mean max-probability; ``phase_shift_decoding``
          retries sub-hop shifts and keeps the best confidence.

Every block of a stack is Conv2d (+ folded BatchNorm) + ReLU except the
stack's last, which stays linear, in ``enc_c`` too (the JAX package's
choice, kept).  The STFT pads each clip to a power-of-two frame bucket
(``_bucket_frames``): the convs see the bucket's zero-audio frames at the
clip's end, so the bucket is part of the function, and the streaming
embedder (``watermark/stream.py``) reproduces it.

The convolutions are ``F.conv2d`` and the FFTs ``torch.fft`` (on a CPU
tensor ``scipy.fft``, as ``watermark/dsp.py``), in float32: cuDNN's TF32
is switched off around the network's convolutions (``_full_f32``).  The
message head of ``decode_wav`` writes message_len × vocab channels per
bin and frame (1,280 × 1,025 per frame at the real grid), so it runs in
time chunks of ``_DECODE_CHUNK`` frames with the stack's halo on each side,
and only over the frames the decode averages: the same function in a
bounded memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import threading
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sesameai_tts_tpu_torch.watermark.dsp import _irfft, _rfft


@dataclass(frozen=True)
class SilentCipherConfig:
    sample_rate: int = 44_100
    n_fft: int = 2048
    hop: int = 512
    message_len: int = 5
    vocab: int = 256
    # decode: a message counts as present when the mean max-prob clears this
    confidence_threshold: float = 0.5
    # embed strength when the caller passes no message_sdr (the reference
    # calls encode_wav(message_sdr=36))
    default_message_sdr: float = 36.0

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


def silentcipher_test_tiny() -> SilentCipherConfig:
    """A small grid for CPU tests."""
    return SilentCipherConfig(sample_rate=44_100, n_fft=128, hop=32)


# ---------------------------------------------------------------------------
# conv blocks (Conv2d semantics: NCHW / OIHW, SAME padding)
# ---------------------------------------------------------------------------

_F32_LOCK = threading.Lock()
_F32_USERS = [0, None]  # [callers inside _full_f32, cuDNN's TF32 flag before the first]


@contextlib.contextmanager
def _full_f32():
    """cuDNN's f32 convolutions without TF32 for the block's duration.
    PyTorch has no per-call switch: ``torch.backends.cudnn.allow_tf32`` is
    one flag for the whole process, so while any caller is inside, every
    thread's f32 cuDNN convolutions run without TF32 (the bf16 Mimi and the
    trunks are not f32 and do not notice).  Concurrent callers share one
    switch: the first in turns TF32 off, the last out restores the setting
    found by the first, overwriting any change another thread made to the
    flag meanwhile."""
    with _F32_LOCK:
        if _F32_USERS[0] == 0:
            _F32_USERS[1] = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _F32_USERS[0] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_USERS[0] -= 1
            if _F32_USERS[0] == 0:
                torch.backends.cudnn.allow_tf32 = _F32_USERS[1]


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    kh, kw = w.shape[2], w.shape[3]
    if kh % 2 and kw % 2:
        return F.conv2d(x, w, b, padding=(kh // 2, kw // 2))
    x = F.pad(x, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2))
    return F.conv2d(x, w, b)


def _stack_apply(blocks, x: torch.Tensor, t_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Sequential conv (+ folded BN) + ReLU blocks, the last block linear.

    ``t_mask`` (broadcastable over the time axis) zeroes activations after
    every block: the streaming embedder runs the blocks on a longer time
    axis than the offline embed, and masking each layer at the offline
    frame count gives the zero padding the offline conv sees at its end."""
    n = len(blocks)
    for i, p in enumerate(blocks):
        x = _conv2d(x, p["w"], p["b"])
        if i < n - 1:
            x = torch.relu(x)
        if t_mask is not None:
            x = x * t_mask
    return x


def _stack_halfwidth(blocks) -> int:
    """Frames of context on each side one output frame of the stack reads."""
    return sum(int(p["w"].shape[3]) // 2 for p in blocks)


# ---------------------------------------------------------------------------
# STFT: torch.stft(center=True, pad_mode='reflect', hann) semantics
# ---------------------------------------------------------------------------


def _frames_for(n: int, cfg: SilentCipherConfig) -> int:
    return 1 + n // cfg.hop  # centered: reflect-pad n_fft//2 on each side


def _bucket_frames(frames: int) -> int:
    return 1 << max(4, (frames - 1).bit_length())


def _window(n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window, as the JAX package builds it."""
    return torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(device)


def _stft(x: torch.Tensor, cfg: SilentCipherConfig, frames: int) -> torch.Tensor:
    pad = cfg.n_fft // 2
    xp = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    segs = xp.unfold(0, cfg.n_fft, cfg.hop)[:frames]
    return _rfft(segs * _window(cfg.n_fft, x.device))  # (frames, n_bins)


def _istft(spec: torch.Tensor, cfg: SilentCipherConfig, length: int) -> torch.Tensor:
    """Windowed overlap-add normalized by Σ win² (floored at 1e-8), as one
    scatter-add over every frame's samples; the reflect pad trimmed."""
    n_fft, hop = cfg.n_fft, cfg.hop
    win = _window(n_fft, spec.device)
    frames = spec.shape[0]
    segs = _irfft(spec, n_fft) * win
    total = (frames - 1) * hop + n_fft
    idx = (torch.arange(frames, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)).reshape(-1)
    out = torch.zeros(total, device=spec.device).index_add_(0, idx, segs.reshape(-1))
    wsum = torch.zeros(total, device=spec.device).index_add_(
        0, idx, (win * win).expand(frames, n_fft).reshape(-1))
    pad = n_fft // 2
    return (out / wsum.clamp_min(1e-8))[pad:pad + length]


# ---------------------------------------------------------------------------
# encode and decode on the watermarker's device
# ---------------------------------------------------------------------------

_DECODE_CHUNK = 128  # frames of message-head output per step


def _resid_spec(params: dict, mag: torch.Tensor, message: torch.Tensor,
                t_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The network's residual magnitude (frames, n_bins) for the STFT
    magnitude ``mag`` (frames, n_bins) carrying ``message``: enc_c on the
    magnitude, then dec_c on [magnitude, features, message channels].
    ``t_mask`` (1, 1, 1, frames), as in ``_stack_apply``, also zeroes the
    inputs of both stacks (the streaming embedder's offline end)."""
    frames = mag.shape[0]
    mag4 = _masked(mag.T[None, None], t_mask)  # (1, 1, F, T)
    with _full_f32():
        feats = _stack_apply(params["enc_c"], mag4, t_mask)
        msg = params["enc_m"][message]  # (message_len, n_bins)
        msg_ch = msg[None, :, :, None].expand(1, msg.shape[0], msg.shape[1], frames)
        # dec_c's input is held by no name here, so the stack frees it after
        # its first block (at the real grid 38 channels × 1025 × 2048, 319 MB)
        return _stack_apply(params["dec_c"], _masked(torch.cat([mag4, feats, msg_ch], dim=1),
                                                     t_mask), t_mask)[0, 0].T


def _masked(x: torch.Tensor, t_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if t_mask is None else x * t_mask


def _embed(params: dict, cfg: SilentCipherConfig, x: torch.Tensor, message: torch.Tensor,
           frames: int, n_valid: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: the clip zero-padded to ``frames * hop`` samples → (the unit-gain
    residual waveform, Σx², Σresid²), the sums over the first ``n_valid``
    samples."""
    spec = _stft(x, cfg, frames)
    mag = spec.abs()
    resid_wav = _istft(_resid_spec(params, mag, message) * (spec / (mag + 1e-8)), cfg,
                       x.shape[0])
    sig = (x[:n_valid] ** 2).sum()
    noise = (resid_wav[:n_valid] ** 2).sum()
    return resid_wav, sig, noise


def _decode(params: dict, cfg: SilentCipherConfig, x: torch.Tensor, frames: int,
            n_valid_frames: int) -> torch.Tensor:
    """x: the clip zero-padded to ``frames * hop`` samples → (message_len,
    vocab) probabilities averaged over the first ``n_valid_frames`` frames."""
    mag4 = _stft(x, cfg, frames).abs().T[None, None]  # (1, 1, F, T)
    stacks = params["dec_m"]
    per_slot = len(stacks) == cfg.message_len and cfg.message_len > 1
    halo = max(_stack_halfwidth(s) for s in stacks)
    chunks = []
    with _full_f32():
        for t0 in range(0, n_valid_frames, _DECODE_CHUNK):
            t1 = min(t0 + _DECODE_CHUNK, n_valid_frames)
            # the halo makes frames [t0, t1) exact; at 0 and at `frames` the
            # conv's own zero padding is the offline program's
            lo, hi = max(0, t0 - halo), min(frames, t1 + halo)
            seg = mag4[..., lo:hi]
            if per_slot:  # one head per byte, vocab on the channel axis
                logits = torch.stack([_stack_apply(s, seg)[0].mean(dim=1) for s in stacks])
            else:  # one stack, fused channels (message_len * vocab, F, T)
                logits = _stack_apply(stacks[0], seg)[0].mean(dim=1).reshape(
                    cfg.message_len, cfg.vocab, hi - lo)
            chunks.append(torch.softmax(logits[..., t0 - lo:t1 - lo], dim=1))
    return torch.cat(chunks, dim=-1).sum(dim=-1) / max(n_valid_frames, 1)


class NetWatermarker:
    """``encode_wav`` / ``decode_wav`` as ``silentcipher.server.Model``
    offers them, over the network's parameters on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, params: dict, cfg: SilentCipherConfig, device="cuda"):
        from sesameai_tts_tpu_torch.convert import tree_map
        from sesameai_tts_tpu_torch.runtime.generator import resolve_device

        self.device = resolve_device(device)
        self.params = tree_map(lambda t: torch.as_tensor(t).to(self.device, torch.float32),
                               params)
        self.cfg = cfg
        self.default_message_sdr = cfg.default_message_sdr

    def _padded(self, x: np.ndarray) -> Tuple[torch.Tensor, int, int]:
        """x → (x zero-padded to its frame bucket, on the device; frames of
        x; the bucket)."""
        nf = _frames_for(len(x), self.cfg)
        frames = _bucket_frames(nf)
        xp = np.pad(x, (0, max(0, frames * self.cfg.hop - len(x))))
        return torch.from_numpy(xp).to(self.device), nf, frames

    def encode_wav(self, audio: np.ndarray, sample_rate: int, message: List[int],
                   calc_sdr: bool = False, message_sdr: Optional[float] = None
                   ) -> Tuple[np.ndarray, Optional[float]]:
        cfg = self.cfg
        if sample_rate != cfg.sample_rate:
            raise ValueError(f"the embed runs at {cfg.sample_rate} Hz, not {sample_rate}")
        if len(message) != cfg.message_len:
            raise ValueError(f"the message has {cfg.message_len} bytes, not {len(message)}")
        sdr = cfg.default_message_sdr if message_sdr is None else message_sdr
        x = np.asarray(audio, np.float32).reshape(-1)
        n = len(x)
        xp, _, frames = self._padded(x)
        msg = torch.tensor(message, dtype=torch.int64, device=self.device)
        resid_wav, sig, noise = _embed(self.params, cfg, xp, msg, frames, n)
        alpha = float(np.sqrt(float(sig) / max(float(noise), 1e-20))) * (
            10.0 ** (-sdr / 20.0))
        y = x + alpha * resid_wav[:n].cpu().numpy()
        out_sdr = None
        if calc_sdr:
            err = y - x
            out_sdr = 10.0 * np.log10(float(np.sum(x ** 2)) / max(float(np.sum(err ** 2)),
                                                                  1e-20))
        return y, out_sdr

    def decode_wav(self, audio: np.ndarray, sample_rate: int,
                   phase_shift_decoding: bool = False,
                   expected_message: Optional[List[int]] = None) -> dict:
        cfg = self.cfg
        if sample_rate != cfg.sample_rate:
            raise ValueError(f"the decode runs at {cfg.sample_rate} Hz, not {sample_rate}")
        x = np.asarray(audio, np.float32).reshape(-1)
        offsets = ([i * max(1, cfg.hop // 4) for i in range(4)]
                   if phase_shift_decoding else [0])
        best = None
        for off in offsets:
            xp, nf, frames = self._padded(x[off:])
            probs = _decode(self.params, cfg, xp, frames, nf).cpu().numpy()
            conf = float(probs.max(axis=1).mean())
            if best is None or conf > best[0]:
                best = (conf, probs)
        conf, probs = best
        message = [int(v) for v in probs.argmax(axis=1)]
        status = conf >= cfg.confidence_threshold
        result = {"status": bool(status), "messages": [message] if status else [],
                  "confidence": conf}
        if expected_message is not None:
            result["expected_confidence"] = float(
                np.mean([probs[s, expected_message[s]] for s in range(cfg.message_len)]))
        return result


# ---------------------------------------------------------------------------
# the silentcipher torch checkpoint → the network's parameters
# ---------------------------------------------------------------------------

_BLOCK_RE = re.compile(r"^(?:(?P<slot>\d+)\.)?(?:\w+\.)?(?P<idx>\d+)\.(?P<rest>.+)$")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _fold_block(entries: dict) -> dict:
    """One sequential block {conv.weight, conv.bias?, bn.*?} → {"w", "b"},
    BatchNorm folded in eval mode (eps 1e-5)."""
    w = None
    for k in ("conv.weight", "weight"):
        if k in entries:
            w = _np(entries[k])
            bias = entries.get(k.replace("weight", "bias"))
            b = np.zeros(w.shape[0], np.float32) if bias is None else _np(bias)
            break
    if w is None:
        raise ValueError(f"block without conv weight: {sorted(entries)}")
    if any(k.startswith("bn.") for k in entries):
        eps = 1e-5
        gamma = _np(entries.get("bn.weight", np.ones(w.shape[0])))
        beta = _np(entries.get("bn.bias", np.zeros(w.shape[0])))
        mean = _np(entries["bn.running_mean"])
        var = _np(entries["bn.running_var"])
        s = gamma / np.sqrt(var + eps)
        w = w * s[:, None, None, None]
        b = (b - mean) * s + beta
    return {"w": torch.from_numpy(np.ascontiguousarray(w, np.float32)),
            "b": torch.from_numpy(np.ascontiguousarray(b, np.float32))}


def _collect_stack(sd: dict) -> Tuple[dict, ...]:
    """Sequential ``<anything>.N.(conv|bn).*`` keys → ordered folded blocks
    (silentcipher's ``main.N.conv.weight`` and bare ``N.weight`` convs)."""
    blocks: dict = {}
    for key, val in sd.items():
        m = _BLOCK_RE.match(key)
        if not m or m.group("slot") is not None:
            continue
        blocks.setdefault(int(m.group("idx")), {})[m.group("rest")] = val
    if not blocks:
        raise ValueError(f"no sequential conv blocks in: {sorted(sd)[:8]}")
    return tuple(_fold_block(blocks[i]) for i in sorted(blocks))


def _split_slots(sd: dict) -> Optional[List[dict]]:
    """ModuleList layout ``{slot}.<stack>...`` → one sub-dict per slot."""
    slots: dict = {}
    for key, val in sd.items():
        m = re.match(r"^(\d+)\.(.+)$", key)
        if not m:
            return None
        slots.setdefault(int(m.group(1)), {})[m.group(2)] = val
    return [slots[i] for i in sorted(slots)] if slots else None


def convert_silentcipher_state(ckpt: dict, hparams: Optional[dict] = None
                               ) -> Tuple[dict, SilentCipherConfig]:
    """silentcipher torch checkpoint → (parameters on the host, config).

    ``ckpt`` holds per-module state dicts under ``enc_c`` / ``dec_c`` /
    ``dec_m`` and the message embedding under ``enc_m`` (a flat state dict
    with those prefixes is split first).  Per-byte ModuleList message heads
    and one fused-channel stack are both taken.  Channels, layers and the
    message band come from the tensors; the STFT grid from ``hparams`` (the
    caller's, over the checkpoint's own ``hparams``)."""
    modules = {k: v for k, v in ckpt.items() if isinstance(v, dict)}
    if not {"enc_c", "dec_c", "dec_m"} <= set(modules):
        flat: dict = {}
        for key, val in ckpt.items():
            if "." in key:
                head, rest = key.split(".", 1)
                flat.setdefault(head, {})[rest] = val
        modules = flat
    missing = {"enc_c", "dec_c", "dec_m"} - set(modules)
    if missing:
        raise ValueError(f"not a silentcipher checkpoint: missing {sorted(missing)}")

    params = {"enc_c": _collect_stack(modules["enc_c"]),
              "dec_c": _collect_stack(modules["dec_c"])}
    emb_cands = [
        (f"{name}.{k}", _np(v))
        for name, src in (("enc_m", modules.get("enc_m", {})),
                          ("msg_encoder", modules.get("msg_encoder", {})))
        for k, v in src.items()
        if k.endswith("weight") and np.ndim(v) == 2
    ]
    if not emb_cands:
        raise ValueError("no message embedding table (enc_m.weight) in checkpoint")
    if len(emb_cands) > 1:
        # binding to whichever came last would take vocab and n_bins from
        # the wrong tensor without a word
        raise ValueError(
            "ambiguous message embedding: multiple 2-D weights "
            f"{[n for n, _ in emb_cands]}; pass a checkpoint with exactly one "
            "enc_m/msg_encoder embedding table")
    emb = emb_cands[0][1]
    params["enc_m"] = torch.from_numpy(np.ascontiguousarray(emb))

    slot_sds = _split_slots(modules["dec_m"])
    if slot_sds is not None:
        params["dec_m"] = tuple(_collect_stack(s) for s in slot_sds)
    else:
        params["dec_m"] = (_collect_stack(modules["dec_m"]),)

    hp = dict(hparams or {})
    if isinstance(ckpt.get("hparams"), dict):
        hp = {**ckpt["hparams"], **hp}
    cfg = SilentCipherConfig(
        sample_rate=int(hp.get("sample_rate", 44_100)),
        n_fft=int(hp.get("n_fft", 2048)),
        hop=int(hp.get("hop_length", hp.get("hop", 512))),
        message_len=int(hp.get("message_len", 5)),
        vocab=int(emb.shape[0]),
    )
    if emb.shape[1] != cfg.n_bins:
        if "n_fft" in hp:
            # an explicit grid the embedding does not span would mark on a
            # grid the reference decoder cannot read
            raise ValueError(
                f"hparams n_fft={cfg.n_fft} implies {cfg.n_bins} bins but the message "
                f"embedding spans {emb.shape[1]}; drop the override or fix it to "
                f"{2 * (emb.shape[1] - 1)}")
        # no explicit grid: the embedding's band fixes n_fft
        cfg = replace(cfg, n_fft=2 * (emb.shape[1] - 1))

    n_msg_in = params["dec_c"][0]["w"].shape[1]
    expect = 1 + params["enc_c"][-1]["w"].shape[0] + cfg.message_len
    if n_msg_in != expect:
        raise ValueError(f"dec_c input channels {n_msg_in} != 1 + enc_c_out + message_len "
                         f"= {expect}; message_len/hparams mismatch")
    return params, cfg


def config_path(path: str) -> str:
    """The config file beside a converted checkpoint."""
    return os.path.abspath(path).rstrip("/") + ".config.json"


def save_converted(path: str, params: dict, cfg: SilentCipherConfig) -> str:
    """The network as the port's converted form: a ``save_pytree`` file and
    its ``<path>.config.json`` → the config's path."""
    from sesameai_tts_tpu_torch.core.weights import save_pytree

    save_pytree(path, params)
    with open(config_path(path), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return config_path(path)


def load_silentcipher_checkpoint(path: str, hparams: Optional[dict] = None, device="cuda"
                                 ) -> NetWatermarker:
    """A silentcipher torch ``.pth``/``.pt`` file, or the port's converted
    form (``sesame-tts-torch-convert silentcipher``: a ``save_pytree`` file
    with ``<path>.config.json`` beside it) → a NetWatermarker on ``device``.
    An orbax directory of the JAX package raises ``ValueError``."""
    from sesameai_tts_tpu_torch.core.weights import _refuse_orbax, load_pytree

    _refuse_orbax(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no silentcipher checkpoint file at {path}")
    if os.path.exists(config_path(path)):
        with open(config_path(path)) as f:
            raw_cfg = json.load(f)
        fields = {f.name for f in dataclasses.fields(SilentCipherConfig)}
        if hparams:  # explicit overrides win, as for a torch file
            # the torch file's key aliases mean the same here
            mapped = {{"hop_length": "hop"}.get(k, k): v for k, v in hparams.items()}
            unknown = set(mapped) - fields
            if unknown:
                raise ValueError(f"unknown hparams override(s) {sorted(unknown)}; valid keys: "
                                 f"{sorted(fields)} (or 'hop_length' for hop)")
            raw_cfg.update(mapped)
        cfg = SilentCipherConfig(**{k: v for k, v in raw_cfg.items() if k in fields})
        return NetWatermarker(load_pytree(path), cfg, device=device)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    params, cfg = convert_silentcipher_state(raw, hparams)
    return NetWatermarker(params, cfg, device=device)


def init_params(cfg: SilentCipherConfig, generator: torch.Generator, hidden: int = 32,
                enc_layers: int = 3, dec_layers: int = 4, msg_layers: int = 3,
                per_slot_heads: bool = False) -> dict:
    """Random parameters in the converter's output structure, on the host,
    drawn from ``generator``."""

    def blk(cin, cout, k=3):
        w = torch.randn((cout, cin, k, k), generator=generator) * (1.0 / np.sqrt(cin * k * k))
        return {"w": w.float(), "b": torch.zeros(cout)}

    def head(cout):
        return tuple([blk(1, hidden)] + [blk(hidden, hidden) for _ in range(msg_layers - 2)]
                     + [blk(hidden, cout)])

    enc = [blk(1, hidden)] + [blk(hidden, hidden) for _ in range(enc_layers - 1)]
    dec = ([blk(1 + hidden + cfg.message_len, hidden)]
           + [blk(hidden, hidden) for _ in range(dec_layers - 2)] + [blk(hidden, 1)])
    dec_m = (tuple(head(cfg.vocab) for _ in range(cfg.message_len)) if per_slot_heads
             else (head(cfg.message_len * cfg.vocab),))
    return {"enc_c": tuple(enc), "dec_c": tuple(dec),
            "enc_m": torch.randn((cfg.vocab, cfg.n_bins), generator=generator),
            "dec_m": dec_m}

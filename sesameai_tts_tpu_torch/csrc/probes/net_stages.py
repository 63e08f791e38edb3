"""The silentcipher network's embed, stage by stage, on the card against
the CPU, at the real grid (44.1 kHz, n_fft 2048, hop 512, hidden 32).

    python3 sesameai_tts_tpu_torch/csrc/probes/net_stages.py

Prints, for each stage of ``watermark/net.py::_embed`` (STFT, magnitude,
phase, enc_c, dec_c, the complex residual, its irfft, the overlap-add), the
largest card-vs-CPU difference relative to the stage's peak and where it
sits, then the same irfft with its input made contiguous first.  Needs a
card; not part of the package's build or tests.

The carrier is made at 24 kHz and resampled, so the bins above ~12 kHz hold
only rounding noise, whose phase each FFT library draws differently; the
script also prints each stage's difference below 11 kHz, and the residual's
after resampling it to the 24 kHz the service ships, on the card against
the CPU and for the card's stream against its offline embed.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sesameai_tts_tpu_torch.audio.resample import resample  # noqa: E402
from sesameai_tts_tpu_torch.service import fixtures  # noqa: E402
from sesameai_tts_tpu_torch.watermark import net  # noqa: E402
from sesameai_tts_tpu_torch.watermark.dsp import _irfft, _rfft  # noqa: E402

KEY = [212, 211, 146, 56, 201]
path = fixtures.write_silentcipher_checkpoint(os.path.join(tempfile.mkdtemp(), "sc.pth"))
models = {d: net.load_silentcipher_checkpoint(path, device=d) for d in ("cuda", "cpu")}
cfg = models["cpu"].cfg
x = resample(cs._speechlike(12.6, 24_000, 3), 24_000, cfg.sample_rate)


def stages(m):
    xp, nf, frames = m._padded(x)
    out = {}
    spec = net._stft(xp, cfg, frames)
    out["spec"] = spec
    mag = spec.abs()
    out["mag"] = mag
    phase = spec / (mag + 1e-8)
    out["phase"] = phase
    mag4 = mag.T[None, None]
    with net._full_f32():
        feats = net._stack_apply(m.params["enc_c"], mag4)
        out["enc_c"] = feats
        msg = m.params["enc_m"][torch.tensor(KEY, device=m.device)]
        msg_ch = msg[None, :, :, None].expand(1, msg.shape[0], msg.shape[1], frames)
        resid = net._stack_apply(m.params["dec_c"], torch.cat([mag4, feats, msg_ch], 1))[0, 0].T
    out["dec_c"] = resid
    z = resid * phase
    out["z"] = z
    out["z_strides"] = torch.tensor(z.stride())
    out["irfft"] = _irfft(z, cfg.n_fft)
    out["irfft_contiguous"] = _irfft(z.contiguous(), cfg.n_fft)
    out["istft"] = net._istft(z, cfg, len(x))
    out["istft_contiguous"] = net._istft(z.contiguous(), cfg, len(x))
    return out


res = {d: {k: v.cpu() for k, v in stages(m).items()} for d, m in models.items()}
lo_bins = int(11_000 * cfg.n_fft / cfg.sample_rate)
for k in ("phase", "z"):
    a, b = res["cuda"][k][:, :lo_bins], res["cpu"][k][:, :lo_bins]
    d = (a - b).abs()
    print(f"{k:18s} below 11 kHz: max|diff| {d.max().item():.4e} "
          f"({d.max().item() / b.abs().max().item():.2e} of peak)", flush=True)
r = {d: res[d]["istft"].numpy() for d in res}
r24 = {d: resample(r[d], cfg.sample_rate, 24_000) for d in r}
print(f"residual at 24 kHz, card vs CPU: max|diff| {np.abs(r24['cuda'] - r24['cpu']).max():.4e} "
      f"of peak {np.abs(r24['cpu']).max():.4e} "
      f"({np.abs(r24['cuda'] - r24['cpu']).max() / np.abs(r24['cpu']).max():.2e})", flush=True)
from sesameai_tts_tpu_torch.watermark import stream  # noqa: E402

se = stream.StreamingNetEmbedder(models["cuda"], KEY, alpha=1.0)
rng = np.random.default_rng(5)
outs, i = [], 0
while i < len(x):
    c = int(rng.integers(2_000, 9_000))
    outs.append(se.feed(x[i:i + c]))
    i += c
outs.append(se.close())
rs = np.concatenate(outs) - x
for name, (a, b) in {"44.1 kHz": (rs, r["cuda"]),
                     "24 kHz": (resample(rs, cfg.sample_rate, 24_000), r24["cuda"])}.items():
    print(f"stream vs offline on the card at {name}: max|diff| {np.abs(a - b).max():.4e} of peak "
          f"{np.abs(b).max():.4e} ({np.abs(a - b).max() / np.abs(b).max():.2e})", flush=True)
print("strides of resid*phase: cuda", res["cuda"]["z_strides"].tolist(), "cpu",
      res["cpu"]["z_strides"].tolist())
for k in res["cpu"]:
    if k == "z_strides":
        continue
    a, b = res["cuda"][k], res["cpu"][k]
    d = (a - b).abs()
    peak = b.abs().max().item()
    i = int(d.argmax())
    print(f"{k:18s} shape {tuple(b.shape)} peak {peak:.4e} max|diff| {d.max().item():.4e} "
          f"({d.max().item() / max(peak, 1e-30):.2e} of peak) at flat index {i} "
          f"= {np.unravel_index(i, tuple(b.shape))}", flush=True)
print(torch.cuda.get_device_name(0), flush=True)

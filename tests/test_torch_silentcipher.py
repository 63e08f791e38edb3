"""The port's silentcipher network (``watermark/net.py``, the network half
of ``watermark/stream.py``) against the JAX package's, at the tiny grid.

Both packages get the same weights: a silentcipher-layout torch
checkpoint through each converter, or the JAX ``init_params`` tree through
``convert.from_jax_params``.  Tolerances: the conv + BN stacks and the STFT
and iSTFT within 2e-4 rel/abs (as the JAX net is held against torch);
the encode residual within 1e-4·max|resid|; Σx², Σresid² and the SDR
within 0.01 dB; the decoded probabilities within 1e-5 abs with the same
message, confidence and expected confidence; the stream against the
offline residual within 5e-5 + 1e-3·max|resid| (the JAX package's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.watermark import api as j_api
from sesameai_tts_tpu.watermark import net as j_net
from sesameai_tts_tpu.watermark import stream as j_stream
from sesameai_tts_tpu_torch.convert import from_jax_params, tree_map
from sesameai_tts_tpu_torch.watermark import api, net, stream
from test_silentcipher import HID, _build_torch_modules, _ckpt_dict, _hparams

KEY = [212, 211, 146, 56, 201]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_service.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(jcfg=None):
    jcfg = jcfg or j_net.silentcipher_test_tiny()
    return jcfg, net.SilentCipherConfig(**dataclasses.asdict(jcfg))


def _np_ckpt(mods, hparams=None):
    return {k: {kk: vv.numpy() if torch.is_tensor(vv) else vv for kk, vv in v.items()}
            for k, v in _ckpt_dict(*mods, hparams).items()}


def _pair(seed=0, per_slot=False):
    """(JAX NetWatermarker, port NetWatermarker on the CPU) of the same
    ``init_params`` draw."""
    jcfg, cfg = _cfgs()
    jp = j_net.init_params(jcfg, jax.random.PRNGKey(seed), per_slot_heads=per_slot)
    params = from_jax_params(jax.tree.map(np.asarray, jp))
    return j_net.NetWatermarker(jp, jcfg), net.NetWatermarker(params, cfg, device="cpu")


def _leaves(tree):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out += _leaves(v)
    else:
        out.append(np.asarray(tree))
    return out


def _signal(n, seed, scale=0.1):
    return (np.random.default_rng(seed).normal(size=n) * scale).astype(np.float32)


def test_converter_checkpoint_roundtrip(tmp_path):
    jcfg, cfg = _cfgs()
    mods = _build_torch_modules(jcfg)
    path = str(tmp_path / "silentcipher.pth")
    torch.save(_ckpt_dict(*mods, _hparams(jcfg)), path)

    wm = net.load_silentcipher_checkpoint(path, device="cpu")
    assert isinstance(wm, net.NetWatermarker)
    assert (wm.cfg.n_fft, wm.cfg.hop, wm.cfg.message_len) == (cfg.n_fft, cfg.hop, 5)
    assert tuple(wm.params["enc_m"].shape) == (cfg.vocab, cfg.n_bins)
    assert (len(wm.params["enc_c"]), len(wm.params["dec_c"])) == (3, 4)
    for blk in wm.params["enc_c"] + wm.params["dec_c"]:  # BN folded into (w, b)
        assert set(blk) == {"w", "b"} and blk["w"].ndim == 4
    # the same folded numbers as the JAX converter's
    jwm = j_net.load_silentcipher_checkpoint(path)
    a, b = _leaves(jwm.params), _leaves(wm.params)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-7)

    # the SDR of the embed is exact by construction (iSTFT linear in the residual)
    x = _signal(int(0.1 * cfg.sample_rate), 1)
    y, sdr = wm.encode_wav(x, cfg.sample_rate, KEY, calc_sdr=True, message_sdr=36.0)
    assert y.shape == x.shape and abs(sdr - 36.0) < 0.2
    res = wm.decode_wav(y, cfg.sample_rate, phase_shift_decoding=True)
    assert set(res) >= {"status", "messages", "confidence"}
    assert isinstance(res["status"], bool)


def test_conv_bn_stack_matches_torch_and_jax():
    """The folded stack against the torch eval-mode forward and the JAX stack."""
    jcfg, cfg = _cfgs()
    enc_c, dec_c, dec_m, enc_m = _build_torch_modules(jcfg, seed=3)
    params, _ = net.convert_silentcipher_state(_np_ckpt((enc_c, dec_c, dec_m, enc_m)),
                                               _hparams(jcfg))
    jparams, _ = j_net.convert_silentcipher_state(_np_ckpt((enc_c, dec_c, dec_m, enc_m)),
                                                  _hparams(jcfg))
    g = np.random.default_rng(4)
    x = g.normal(size=(1, 1, cfg.n_bins, 17)).astype(np.float32)
    with torch.no_grad():
        t = torch.from_numpy(x)
        for blk in list(enc_c.main)[:-1]:
            t = blk(t)
        t = enc_c.main[-1].bn(enc_c.main[-1].conv(t))  # the stack's last block is linear
        ours = net._stack_apply(params["enc_c"], torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), t.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(j_net._stack_apply(jparams["enc_c"], jnp.asarray(x))),
        rtol=2e-4, atol=2e-4)

    xm = g.normal(size=(1, 1 + HID + cfg.message_len, cfg.n_bins, 17)).astype(np.float32)
    with torch.no_grad():
        td = dec_c(torch.from_numpy(xm))
        ours_d = net._stack_apply(params["dec_c"], torch.from_numpy(xm))
    np.testing.assert_allclose(ours_d.numpy(), td.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        ours_d.numpy(), np.asarray(j_net._stack_apply(jparams["dec_c"], jnp.asarray(xm))),
        rtol=2e-4, atol=2e-4)
    assert net._stack_halfwidth(params["dec_c"]) == 4


@pytest.mark.parametrize("n", [16 * 32, 5 * 32 * 37 + 13])
def test_stft_and_istft_match_jax(n):
    jcfg, cfg = _cfgs()
    frames = net._bucket_frames(net._frames_for(n, cfg))
    assert frames == j_net._bucket_frames(j_net._frames_for(n, jcfg))
    x = np.pad(_signal(n, 5, 0.3), (0, frames * cfg.hop - n))
    spec = net._stft(torch.from_numpy(x), cfg, frames)
    jspec = np.asarray(j_net._stft(jnp.asarray(x), jcfg, frames))
    assert spec.shape == jspec.shape == (frames, cfg.n_bins)
    np.testing.assert_allclose(spec.numpy(), jspec, rtol=2e-4, atol=2e-4)
    g = np.random.default_rng(6)
    z = (g.normal(size=jspec.shape) + 1j * g.normal(size=jspec.shape)).astype(np.complex64)
    back = net._istft(torch.from_numpy(z), cfg, n).numpy()
    np.testing.assert_allclose(back, np.asarray(j_net._istft(jnp.asarray(z), jcfg, n)),
                               rtol=2e-4, atol=2e-4)
    # analysis then synthesis gives the signal back
    np.testing.assert_allclose(net._istft(spec, cfg, n).numpy(), x[:n], atol=1e-5)


@pytest.mark.parametrize("n", [int(0.1 * 44_100), 5 * 32 * 37 + 13])
def test_encode_residual_matches_jax(n):
    jwm, wm = _pair(0)
    cfg = wm.cfg
    x = _signal(n, 7, 0.2)
    frames = net._bucket_frames(net._frames_for(n, cfg))
    xp = np.pad(x, (0, frames * cfg.hop - n))
    resid, sig, noise = net._embed(wm.params, cfg, torch.from_numpy(xp),
                                   torch.tensor(KEY), frames, n)
    jres, jsig, jnoise = j_net._embed_jit(jwm.params, jwm.cfg, jnp.asarray(xp),
                                          jnp.asarray(KEY, jnp.int32), frames, jnp.int32(n))
    jres = np.asarray(jres)
    np.testing.assert_allclose(resid.numpy(), jres, atol=1e-4 * np.abs(jres).max())
    db = lambda s, e: 10 * np.log10(float(s) / float(e))  # noqa: E731
    assert abs(10 * np.log10(float(sig) / float(jsig))) < 0.01
    assert abs(10 * np.log10(float(noise) / float(jnoise))) < 0.01
    assert abs(db(sig, noise) - db(jsig, jnoise)) < 0.01
    y, sdr = wm.encode_wav(x, cfg.sample_rate, KEY, calc_sdr=True)
    jy, jsdr = jwm.encode_wav(x, cfg.sample_rate, KEY, calc_sdr=True)
    assert abs(sdr - jsdr) < 0.01 and abs(sdr - cfg.default_message_sdr) < 0.2
    np.testing.assert_allclose(y - x, jy - x, atol=1e-4 * np.abs(jy - x).max())


@pytest.mark.parametrize("phase_shift", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_matches_jax(phase_shift, per_slot):
    """Probabilities within 1e-5; the message, the confidence and the
    expected confidence as JAX's.  0.3 s is ~410 frames: several of the
    port's decode chunks."""
    jwm, wm = _pair(1, per_slot=per_slot)
    assert len(wm.params["dec_m"]) == (5 if per_slot else 1)
    cfg = wm.cfg
    x = _signal(int(0.3 * cfg.sample_rate), 8)
    y, _ = wm.encode_wav(x, cfg.sample_rate, KEY)
    for audio in (x, y):
        nf = net._frames_for(len(audio), cfg)
        frames = net._bucket_frames(nf)
        xp = np.pad(audio, (0, frames * cfg.hop - len(audio)))
        probs = net._decode(wm.params, cfg, torch.from_numpy(xp), frames, nf).numpy()
        jprobs = np.asarray(j_net._decode_jit(jwm.params, jwm.cfg, jnp.asarray(xp), frames,
                                              jnp.int32(nf)))
        np.testing.assert_allclose(probs, jprobs, atol=1e-5)
        r = wm.decode_wav(audio, cfg.sample_rate, phase_shift_decoding=phase_shift,
                          expected_message=KEY)
        jr = jwm.decode_wav(audio, cfg.sample_rate, phase_shift_decoding=phase_shift,
                            expected_message=KEY)
        assert r["status"] == jr["status"] and r["messages"] == jr["messages"]
        assert abs(r["confidence"] - jr["confidence"]) < 1e-5
        assert abs(r["expected_confidence"] - jr["expected_confidence"]) < 1e-5
        assert int(np.argmax(probs, axis=1)[0]) == int(np.argmax(jprobs, axis=1)[0])


def test_per_slot_message_decoder_layout():
    jcfg, cfg = _cfgs()
    mods = _build_torch_modules(jcfg, seed=5, per_slot=True)
    params, ccfg = net.convert_silentcipher_state(_np_ckpt(mods), _hparams(jcfg))
    jparams, jccfg = j_net.convert_silentcipher_state(_np_ckpt(mods), _hparams(jcfg))
    assert len(params["dec_m"]) == cfg.message_len
    x = _signal(4410, 6)
    r = net.NetWatermarker(params, ccfg, device="cpu").decode_wav(x, cfg.sample_rate)
    jr = j_net.NetWatermarker(jparams, jccfg).decode_wav(x, cfg.sample_rate)
    assert len(r["messages"]) in (0, 1) and isinstance(r["confidence"], float)
    assert r["messages"] == jr["messages"] and abs(r["confidence"] - jr["confidence"]) < 1e-5


def _rejects():
    jcfg, _ = _cfgs()
    mods = _build_torch_modules(jcfg, seed=2)
    two_tables = _np_ckpt(mods, _hparams(jcfg))
    two_tables["msg_encoder"] = {"weight": np.zeros((256, 65), np.float32)}
    wrong_len = dict(_np_ckpt(mods), hparams={**_hparams(jcfg), "message_len": 4})
    return [
        ("missing", {"foo": {"0.weight": np.zeros((1, 1, 3, 3))}}, None),
        ("ambiguous", two_tables, None),
        ("implies", _np_ckpt(mods), {"n_fft": 256}),
        ("dec_c input channels", wrong_len, None),
        ("no message embedding", {k: v for k, v in _np_ckpt(mods).items() if k != "enc_m"},
         None),
    ]


@pytest.mark.parametrize("case", range(5))
def test_converter_rejects(case):
    """Each checkpoint the JAX converter rejects, the port's rejects with the
    same error."""
    match, ckpt, hp = _rejects()[case]
    with pytest.raises(ValueError, match=match):
        j_net.convert_silentcipher_state(ckpt, hp)
    with pytest.raises(ValueError, match=match):
        net.convert_silentcipher_state(ckpt, hp)


def test_hparams_inferred_from_embedding_band():
    """Without hparams the embedding's band size fixes n_fft."""
    jcfg, cfg = _cfgs()
    mods = _build_torch_modules(jcfg, seed=7)
    _, ccfg = net.convert_silentcipher_state(_np_ckpt(mods))
    _, jccfg = j_net.convert_silentcipher_state(_np_ckpt(mods))
    assert ccfg.n_fft == jccfg.n_fft == cfg.n_fft  # 2 * (n_bins - 1)
    assert dataclasses.asdict(ccfg) == dataclasses.asdict(jccfg)


def test_init_params_structure_matches_jax():
    jcfg, cfg = _cfgs()
    for per_slot in (False, True):
        p = net.init_params(cfg, torch.Generator().manual_seed(0), per_slot_heads=per_slot)
        jp = j_net.init_params(jcfg, jax.random.PRNGKey(0), per_slot_heads=per_slot)
        assert [a.shape for a in _leaves(p)] == [a.shape for a in _leaves(jp)]
        assert all(a.dtype == np.float32 for a in _leaves(p))
        again = net.init_params(cfg, torch.Generator().manual_seed(0), per_slot_heads=per_slot)
        assert all(np.array_equal(a, b) for a, b in zip(_leaves(p), _leaves(again)))


def test_api_backend_selection(tmp_path, monkeypatch):
    from sesameai_tts_tpu.audio.resample import resample as j_resample
    from sesameai_tts_tpu_torch.watermark.dsp import Watermarker

    monkeypatch.delenv("SILENTCIPHER_CKPT", raising=False)
    assert isinstance(api.load_watermarker(device="cpu"), Watermarker)
    jcfg, cfg = _cfgs()
    path = str(tmp_path / "sc.pth")
    torch.save(_ckpt_dict(*_build_torch_modules(jcfg, seed=8), _hparams(jcfg)), path)

    wm = api.load_watermarker(ckpt_path=path, device="cpu")
    assert isinstance(wm, net.NetWatermarker)
    assert all(t.device.type == "cpu" for t in _tensors(wm.params))
    # watermark() takes the network's 36 dB strength and the reference's resampling
    audio = _signal(2400, 9)
    out, rate = api.watermark(wm, audio, 24_000, KEY)
    assert rate == 24_000
    base = j_resample(j_resample(audio, 24_000, 44_100), 44_100, 24_000)
    m = min(len(out), len(base))
    noise = out[:m] - base[:m]
    assert 10 * np.log10(np.sum(base[:m] ** 2) / max(np.sum(noise ** 2), 1e-20)) > 30.0
    # the JAX package marks the same audio the same way
    jout, jrate = j_api.watermark(j_api.load_watermarker(ckpt_path=path), audio, 24_000, KEY)
    assert jrate == rate
    np.testing.assert_allclose(out, jout, atol=1e-4 * np.abs(jout - base[:len(jout)]).max())

    monkeypatch.setenv("SILENTCIPHER_CKPT", path)
    assert isinstance(api.load_watermarker(device="cpu"), net.NetWatermarker)


def _tensors(tree):
    out = []
    tree_map(out.append, tree)
    return out


def test_converted_form_and_its_overrides(tmp_path):
    """``save_converted`` + ``<dst>.config.json`` loads as the torch file does;
    ``hop_length`` is an alias of ``hop``; unknown overrides and an orbax
    directory are refused; the card is the default device."""
    jcfg, cfg = _cfgs()
    src = str(tmp_path / "sc.pth")
    torch.save(_ckpt_dict(*_build_torch_modules(jcfg, seed=9), _hparams(jcfg)), src)
    wm = net.load_silentcipher_checkpoint(src, device="cpu")
    dst = str(tmp_path / "wm.safetensors")
    assert net.save_converted(dst, wm.params, wm.cfg) == dst + ".config.json"
    again = net.load_silentcipher_checkpoint(dst, device="cpu")
    assert again.cfg == wm.cfg
    assert all(torch.equal(a, b) for a, b in zip(_tensors(wm.params), _tensors(again.params)))
    assert net.load_silentcipher_checkpoint(dst, {"hop_length": 16}, device="cpu").cfg.hop == 16
    with pytest.raises(ValueError, match="unknown hparams"):
        net.load_silentcipher_checkpoint(dst, {"hops": 16}, device="cpu")
    orbax = tmp_path / "wm_jax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        net.load_silentcipher_checkpoint(str(orbax), device="cpu")
    with pytest.raises(FileNotFoundError):
        net.load_silentcipher_checkpoint(str(tmp_path / "nope.pth"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            net.load_silentcipher_checkpoint(src)
        with pytest.raises(RuntimeError, match="CUDA"):
            api.load_watermarker(ckpt_path=src)


def test_watermark_and_verify_at_the_backends_rate(tmp_path):
    """A checkpoint whose hparams give 16 kHz: watermark() resamples to
    16 kHz and back, as the JAX package's does (the output's rate and
    samples), and verify() decodes at 16 kHz."""
    jcfg, _ = _cfgs()
    path = str(tmp_path / "sc16.pth")
    torch.save(_ckpt_dict(*_build_torch_modules(jcfg, seed=10),
                          {**_hparams(jcfg), "sample_rate": 16_000}), path)
    wm = api.load_watermarker(ckpt_path=path, device="cpu")
    jwm = j_api.load_watermarker(ckpt_path=path)
    assert wm.cfg.sample_rate == jwm.cfg.sample_rate == 16_000
    audio = _signal(24_000, 11)
    out, rate = api.watermark(wm, audio, 24_000, KEY)
    jout, jrate = j_api.watermark(jwm, audio, 24_000, KEY)
    assert rate == jrate == 16_000 and out.shape == jout.shape
    np.testing.assert_allclose(out, jout, atol=1e-5)
    assert api.verify(wm, out, rate, KEY) == j_api.verify(jwm, jout, jrate, KEY)


def _stream(se, x, seed, lo=50, hi=900):
    rng = np.random.default_rng(seed)
    outs, i = [], 0
    while i < len(x):
        c = int(rng.integers(lo, hi))
        outs.append(se.feed(x[i:i + c]))
        i += c
    outs.append(se.close())
    return np.concatenate(outs)


def _offline_resid(wm, x):
    cfg = wm.cfg
    frames = net._bucket_frames(net._frames_for(len(x), cfg))
    xp = np.pad(x, (0, frames * cfg.hop - len(x)))
    return net._embed(wm.params, cfg, torch.from_numpy(xp), torch.tensor(KEY), frames,
                      len(x))[0].numpy()[:len(x)]


@pytest.mark.parametrize("n", [5 * 32 * 37 + 13, 32 * 32 - 1, 32 * 32 - 20, 64 * 32 - 16])
def test_streaming_net_embed_matches_offline(n):
    """StreamingNetEmbedder(alpha=1) gives the offline residual, at an
    awkward length and where 1 + n//hop lands exactly on the frame bucket
    (the end reflect pad mirrors real samples there)."""
    _, wm = _pair(0)
    cfg = wm.cfg
    if n != 5 * 32 * 37 + 13:
        assert net._bucket_frames(net._frames_for(n, cfg)) == net._frames_for(n, cfg)
    x = _signal(n, 7 + n % 5, 0.2)
    off = _offline_resid(wm, x)
    y = _stream(stream.StreamingNetEmbedder(wm, KEY, alpha=1.0), x, n)
    assert len(y) == n
    np.testing.assert_allclose(y - x, off, atol=5e-5 + 1e-3 * np.abs(off).max())


def test_streaming_net_matches_the_jax_stream():
    """The port's stream and the JAX package's, on the same input and chunks,
    with the pinned gain and with the cumulative one."""
    jwm, wm = _pair(2)
    x = _signal(7 * 32 * 29 + 5, 12, 0.2)
    for alpha in (1.0, None):
        y = _stream(stream.StreamingNetEmbedder(wm, KEY, alpha=alpha), x, 3)
        jy = _stream(j_stream.StreamingNetEmbedder(jwm, KEY, alpha=alpha), x, 3)
        assert y.shape == jy.shape == x.shape
        np.testing.assert_allclose(y - x, jy - x, atol=5e-5 + 1e-3 * np.abs(jy - x).max())


def test_streaming_net_pipeline_shape_and_latency():
    """resample → embed → resample keeps the length and emits long before
    the 4 s groups would; make_streaming_watermarker dispatches to it."""
    _, wm = _pair(1)
    pipe = stream.make_streaming_watermarker(wm, [1, 2, 3, 4, 5], 24_000)
    assert pipe is not None and isinstance(pipe._emb, stream.StreamingNetEmbedder)
    audio = _signal(24_000 * 2, 3)
    outs, first_at, fed = [], None, 0
    for i in range(0, len(audio), 1920):
        out = pipe.feed(audio[i:i + 1920])
        fed += 1920
        if len(out) and first_at is None:
            first_at = fed
        outs.append(out)
    outs.append(pipe.close())
    y = np.concatenate(outs)
    assert abs(len(y) - len(audio)) <= 2 and np.isfinite(y).all()
    assert first_at is not None and first_at <= 24_000


@pytest.mark.slow
def test_streaming_net_real_dims_embed_and_decode():
    """At the real grid (44.1 kHz, n_fft 2048, hop 512): the port's offline
    residual and decode against JAX's, and its stream against its offline
    residual."""
    jcfg, cfg = _cfgs(j_net.SilentCipherConfig())
    assert (cfg.n_bins, cfg.hop) == (1025, 512)
    jp = j_net.init_params(jcfg, jax.random.PRNGKey(0))
    jwm = j_net.NetWatermarker(jp, jcfg)
    wm = net.NetWatermarker(from_jax_params(jax.tree.map(np.asarray, jp)), cfg, device="cpu")
    n = 37 * cfg.hop + 201
    x = _signal(n, 42, 0.2)
    off = _offline_resid(wm, x)
    frames = net._bucket_frames(net._frames_for(n, cfg))
    jres = np.asarray(j_net._embed_jit(jp, jcfg, jnp.asarray(np.pad(x, (0, frames * 512 - n))),
                                       jnp.asarray(KEY, jnp.int32), frames, jnp.int32(n))[0])[:n]
    np.testing.assert_allclose(off, jres, atol=1e-4 * np.abs(jres).max())
    y = _stream(stream.StreamingNetEmbedder(wm, KEY, alpha=1.0), x, 1, 800, 6000)
    np.testing.assert_allclose(y - x, off, atol=5e-5 + 1e-3 * np.abs(off).max())
    r = wm.decode_wav(y, cfg.sample_rate, phase_shift_decoding=True, expected_message=KEY)
    jr = jwm.decode_wav(y, cfg.sample_rate, phase_shift_decoding=True, expected_message=KEY)
    assert r["messages"] == jr["messages"]
    assert abs(r["confidence"] - jr["confidence"]) < 1e-5

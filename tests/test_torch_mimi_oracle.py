"""The port's Mimi against transformers' ``MimiModel`` (the published
port of kyutai's Mimi), no JAX in between: a random-init ``MimiModel``'s
state dict, written as a transformers-layout safetensors file, loads
through the port's ``load_mimi_checkpoint``; the port's encode gives the
same codes bit for bit and its decode (offline and streamed) the same PCM
within the JAX oracle test's tolerance (tests/test_mimi_oracle.py)."""

import numpy as np
import pytest
import torch

from sesameai_tts_tpu_torch.codec.mimi import Mimi, mimi_test_tiny
from sesameai_tts_tpu_torch.core.weights import load_mimi_checkpoint, write_safetensors

# decode PCM, relative to the oracle's peak: f32 in both, another order of
# sums in the convolutions and the attention
PCM_ATOL_OF_PEAK = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager CPU work here is many small ops: with several test
    workers sharing the cores, torch's intra-op threads mostly wait on each
    other (on an 8-core host with six workers, a tiny decode ran ~50x slower
    at 8 threads than at 1), so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_hf_mimi(seed=0):
    """transformers MimiModel topologically identical to mimi_test_tiny()."""
    from transformers.models.mimi import MimiConfig, MimiModel

    cfg = MimiConfig(
        audio_channels=1, num_filters=4, upsampling_ratios=[4, 3, 2],
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, intermediate_size=64,
        codebook_size=32, codebook_dim=16, num_quantizers=8,
        num_semantic_quantizers=1, sliding_window=16,
        vector_quantization_hidden_dimension=16, upsample_groups=32,
        frame_rate=500, sampling_rate=24_000, use_cache=False,
    )
    torch.manual_seed(seed)
    m = MimiModel(cfg).eval()
    # spread the codebooks: random-init embed_sum leaves near-duplicate
    # entries whose argmin ties are fragile (trained codebooks are apart)
    with torch.no_grad():
        for q in (m.quantizer.semantic_residual_vector_quantizer,
                  m.quantizer.acoustic_residual_vector_quantizer):
            for layer in q.layers:
                layer.codebook.embed_sum.normal_()
                layer.codebook.cluster_usage.fill_(1.0)
                layer.codebook.initialized.fill_(True)
    return m


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    hf = _tiny_hf_mimi()
    path = str(tmp_path_factory.mktemp("mimi_hf") / "hf_tiny.safetensors")
    write_safetensors(path, {k: v.detach() for k, v in hf.state_dict().items()})
    mine = Mimi(mimi_test_tiny())
    return hf, mine, load_mimi_checkpoint(path, mine)


def _close(got, want):
    n = min(len(got), len(want))
    assert n > 0
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got[:n] / scale, want[:n] / scale, rtol=0,
                               atol=PCM_ATOL_OF_PEAK)


def test_encode_codes_bit_exact(oracle):
    hf, mine, params = oracle
    wav = torch.from_numpy((np.random.default_rng(0).normal(size=16 * 48) * 0.1)
                           .astype(np.float32))[None, None]
    with torch.no_grad():
        want = hf.encode(wav).audio_codes
        got = mine.encode(params, wav)
    assert got.shape == want.shape
    assert torch.equal(got.to(want.dtype), want)


def test_decode_pcm_matches(oracle):
    hf, mine, params = oracle
    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 32, size=(1, 8, 16)))
    with torch.no_grad():
        want = hf.decode(codes).audio_values[0, 0].numpy()
        got = mine.decode(params, codes)[0, 0].numpy()
    _close(got, want)


def test_streaming_decode_matches_offline_oracle(oracle):
    hf, mine, params = oracle
    codes = torch.from_numpy(np.random.default_rng(2).integers(0, 32, size=(1, 8, 12)))
    with torch.no_grad():
        want = hf.decode(codes).audio_values[0, 0].numpy()
        st = mine.init_decode_state(1)
        outs = []
        for i in range(0, 12, 4):
            y, st = mine.decode_streaming(params, codes[:, :, i:i + 4], st)
            outs.append(y[0, 0].numpy())
    _close(np.concatenate(outs), want)

"""Port config parity: every field of every flavor equals the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from sesameai_tts_tpu.codec import mimi as jmimi
from sesameai_tts_tpu.core import config as jc
from sesameai_tts_tpu_torch.codec import mimi as tmimi
from sesameai_tts_tpu_torch.core import config as tc


def _norm(value):
    """Field values with dtypes reduced to their names."""
    if isinstance(value, torch.dtype):
        return str(value).split(".")[-1]
    if isinstance(value, type) and hasattr(value, "dtype"):  # jnp scalar types
        return np.dtype(value).name
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items()}
    return value


def _fields(cfg):
    return _norm(
        {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                  if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name))
         for f in dataclasses.fields(cfg)}
    )


@pytest.mark.parametrize("flavor", ["llama-1B", "llama-100M", "test-tiny", "test-tiny-decoder"])
def test_flavor_fields_equal(flavor):
    j, t = jc.get_flavor(flavor), tc.get_flavor(flavor)
    assert _fields(t) == _fields(j)
    assert t.head_dim == j.head_dim
    assert isinstance(t.dtype, torch.dtype)


@pytest.mark.parametrize("name", ["csm_1b", "csm_test_tiny"])
def test_csm_config_equal(name):
    j, t = getattr(jc, name)(), getattr(tc, name)()
    assert _fields(t) == _fields(j)
    assert _fields(t.backbone) == _fields(j.backbone)
    assert _fields(t.decoder) == _fields(j.decoder)
    assert t.frame_width == j.frame_width
    assert _fields(t.replace(max_seq_len=512).backbone) == _fields(j.replace(max_seq_len=512).backbone)


@pytest.mark.parametrize("name", ["MimiConfig", "mimi_test_tiny"])
def test_mimi_config_equal(name):
    j, t = getattr(jmimi, name)(), getattr(tmimi, name)()
    assert _norm(dataclasses.asdict(t)) == _norm(dataclasses.asdict(j))
    assert t.hop_length == j.hop_length
    assert t.max_latent_positions == j.max_latent_positions
    assert tmimi.Mimi(t).max_stream_chunk_frames == jmimi.Mimi(j).max_stream_chunk_frames


def test_sampling_and_generation_config_equal():
    assert dataclasses.asdict(tc.SamplingConfig()) == dataclasses.asdict(jc.SamplingConfig())
    assert dataclasses.asdict(tc.GenerationConfig()) == dataclasses.asdict(jc.GenerationConfig())
    assert tc.GenerationConfig().max_frames == jc.GenerationConfig().max_frames

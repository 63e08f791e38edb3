"""The port's Llama-3 BPE tokenizers (``tokenizer/native_bpe.py``,
``tokenizer/text.py``) against the JAX package's and the Rust
``tokenizers`` library: equal ids on ASCII and non-ASCII text, decode
round trips, the exact-first backend order with its warning, tokenizer
inference from a checkpoint directory, the guard against a checkpoint
paired with a test tokenizer, and a Generator built from a checkpoint
directory giving the JAX package's greedy frames."""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sesameai_tts_tpu.runtime import loader as j_loader
from sesameai_tts_tpu.service.fixtures import write_csm_dir, write_tokenizer_json
from sesameai_tts_tpu.tokenizer import native_bpe as j_native
from sesameai_tts_tpu.tokenizer import text as j_text
from sesameai_tts_tpu_torch.runtime import loader
from sesameai_tts_tpu_torch.tokenizer import native_bpe, text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ASCII = [
    "The quick brown fox jumps over the lazy dog.",
    "[1]hello world, numbers 987 and synthesis!",
    "unseen words decompose into pieces",
    "punctuation?! spacing  and\nnewlines",
]
NON_ASCII = [
    "Café naïve façade, über straße — déjà vu!",
    "日本語のテキスト and emoji 🎉 too",
    "Zoë's résumé: 12345678 ñandúes",
    "I'LL say we've\n\n  ünïcödé",
]
# the published Llama-3 tokenizer.json's pretokenizer pattern (the Rust
# library's regex has no possessive quantifiers; the native one uses them)
_LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


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


@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    """The fixture tokenizer.json (trained, GPT-2 byte-level pretokenizer,
    as the JAX tests use) and the same vocab and merges with the Llama-3
    pretokenizer."""
    from tokenizers import Regex, Tokenizer, pre_tokenizers

    d = tmp_path_factory.mktemp("tok")
    plain = write_tokenizer_json(str(d / "tokenizer.json"))
    tok = Tokenizer.from_file(plain)
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(_LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    llama3 = str(d / "llama3.json")
    tok.save(llama3)
    return plain, llama3


def _rust_ids(path, s):
    from tokenizers import Tokenizer

    return Tokenizer.from_file(path).encode(s, add_special_tokens=False).ids


@pytest.mark.parametrize("which", ["plain", "llama3"])
def test_native_bpe_equals_jax_and_rust(tok_files, which):
    path = tok_files[0] if which == "plain" else tok_files[1]
    port = native_bpe.NativeBPETokenizer(path)
    jax_tok = j_native.NativeBPETokenizer(path)
    assert (port.bos_id, port.eos_id, port.vocab_size) == \
        (jax_tok.bos_id, jax_tok.eos_id, jax_tok.vocab_size)
    # the GPT-2 pattern of the plain file differs from Llama-3's off ASCII
    for s in ASCII + (NON_ASCII if which == "llama3" else []):
        ids = port.encode(s)
        assert ids == jax_tok.encode(s), s
        assert ids[0] == port.bos_id and ids[-1] == port.eos_id
        assert ids[1:-1] == _rust_ids(path, s), s
        assert port.decode(ids) == s
    for s in NON_ASCII:  # the two native tokenizers agree everywhere
        assert port.encode(s) == jax_tok.encode(s), s


def test_load_llama3_tokenizer_and_backend_order(tok_files, monkeypatch):
    _, path = tok_files
    tok = text.load_llama3_tokenizer(path)
    assert isinstance(tok, native_bpe.NativeBPETokenizer)  # exact native first
    for s in ASCII + NON_ASCII:
        assert tok.encode(s) == j_text.load_llama3_tokenizer(path).encode(s)
    hf = text.HFTokenizer(os.path.dirname(path))  # a model dir → its tokenizer.json
    assert hf.encode(ASCII[0]) == j_text.HFTokenizer(os.path.dirname(path)).encode(ASCII[0])
    assert hf.decode(hf.encode(ASCII[1])) == ASCII[1]
    # without the regex module the native tokenizer steps aside for the Rust one ...
    monkeypatch.setattr(native_bpe, "has_exact_pretokenizer", lambda: False)
    assert isinstance(text.load_llama3_tokenizer(path), text.HFTokenizer)

    # ... and without that too, the approximate native one loads with a warning
    def no_rust(*a, **k):
        raise ImportError("no tokenizers")

    monkeypatch.setattr(text, "HFTokenizer", no_rust)
    with pytest.warns(UserWarning, match="ASCII-approximate"):
        approx = text.load_text_tokenizer(path)
    assert isinstance(approx, native_bpe.NativeBPETokenizer)
    assert approx.encode(ASCII[0]) == tok.encode(ASCII[0])


def test_byte_and_tiny_unchanged():
    for spec in ("byte", "tiny"):
        p, j = text.load_text_tokenizer(spec), j_text.load_text_tokenizer(spec)
        assert p.encode("hello world") == j.encode("hello world")


def test_bench_tokenizer_asset_is_the_jax_packages():
    mine = os.path.join(REPO, "sesameai_tts_tpu_torch", "assets", "bench_tokenizer.json")
    theirs = os.path.join(REPO, "sesameai_tts_tpu", "assets", "bench_tokenizer.json")
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with open(mine) as f:
        assert len(json.load(f)["model"]["vocab"]) == 608
    tok = text.load_text_tokenizer(mine)
    assert tok.encode(ASCII[0]) == j_text.load_text_tokenizer(theirs).encode(ASCII[0])


def test_resolve_tokenizer_matches_jax(tmp_path, tok_files):
    model_dir = tmp_path / "csm"
    model_dir.mkdir()
    ckpt = model_dir / "model.safetensors"
    ckpt.write_bytes(b"")
    cases = [(None, None), (None, str(model_dir)), (None, str(ckpt)), ("tiny", str(model_dir))]
    for tok, path in cases:
        assert loader.resolve_tokenizer(tok, path) == j_loader.resolve_tokenizer(tok, path)
    assert loader.resolve_tokenizer(None, str(model_dir)) == "byte"
    shutil.copy(tok_files[0], model_dir / "tokenizer.json")
    for tok, path in cases:
        assert loader.resolve_tokenizer(tok, path) == j_loader.resolve_tokenizer(tok, path)
    want = str(model_dir / "tokenizer.json")
    assert loader.resolve_tokenizer(None, str(model_dir)) == want
    assert loader.resolve_tokenizer(None, str(ckpt)) == want
    assert loader.csm_1b_spec(str(model_dir)).tokenizer == want
    assert loader.csm_1b_spec(str(model_dir), tokenizer="byte").tokenizer == "byte"


def test_checkpoint_with_test_tokenizer_raises():
    spec = dataclasses.replace(loader.test_tiny_spec(), tokenizer="byte",
                               csm_checkpoint="/nonexistent/model.safetensors")
    spec.csm = dataclasses.replace(spec.csm, text_vocab_size=20_000)
    with pytest.raises(ValueError, match="tokenizer"):
        loader.build_generator(spec, device="cpu")


def test_generator_from_checkpoint_dir_equals_jax(tmp_path):
    """A tiny checkpoint directory (model.safetensors + tokenizer.json) as
    the JAX fixtures write it: the tokenizer is inferred, and the port's
    Generator gives the JAX Generator's greedy frames."""
    from sesameai_tts_tpu.service.fixtures import fixture_csm_config

    d = write_csm_dir(str(tmp_path / "csm"), flavor="test-tiny")
    j_spec = dataclasses.replace(j_loader.test_tiny_spec(), csm=fixture_csm_config("test-tiny"),
                                 csm_checkpoint=d, tokenizer=j_loader.resolve_tokenizer(None, d))
    spec = dataclasses.replace(loader.test_tiny_spec(), csm_checkpoint=d,
                               tokenizer=loader.resolve_tokenizer(None, d))
    spec.csm = dataclasses.replace(spec.csm, text_vocab_size=512)
    jg = j_loader.build_generator(j_spec, decode_chunk_frames=4)
    tg = loader.build_generator(spec, device="cpu", decode_chunk_frames=4)
    assert isinstance(tg._tokenizer.text_tokenizer, native_bpe.NativeBPETokenizer)
    kw = dict(max_audio_length_ms=800, temperature=1.0, topk=1)
    want = jg.generate_frames("Hello from a checkpoint.", 0, [], seed=0, **kw)
    np.testing.assert_array_equal(tg.generate_frames("Hello from a checkpoint.", 0, [], **kw),
                                  want)
    params = jax.tree.map(np.asarray, jg._params)
    assert np.array_equal(tg._params["projection"].numpy(), params["projection"])
    assert tg._params["backbone"]["layers"][0]["qkv"].dtype == torch.float32

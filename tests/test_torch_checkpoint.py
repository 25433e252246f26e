"""Checkpoint loading in the PyTorch port against the JAX package, on the
CPU: the port's safetensors reader and writer against the safetensors
package; ``load_model`` on a tiny HF checkpoint written by transformers
(real key names, the large-v3 vocabulary and mel count) against the JAX
``load_model``, bit for bit in f32; the engine built from that directory
(tokenizer layout, alignment heads, start-up smoke test, a NaN-poisoned
copy failing at construction) and its transcript against the JAX
engine's on the same directory."""

import json
import shutil
from dataclasses import asdict

import numpy as np
import pytest
import torch

from torch_port_util import speechy_audio
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.models import loader as TL
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.utils import params_io as PIO

from tests.test_checkpoint_load import CORPUS, train_bpe

SR = 16_000
HEADS = [(1, 0), (1, 1)]


# ---------------------------------------------------------------------------
# safetensors reader and writer
# ---------------------------------------------------------------------------


def _array(dtype: str, rng):
    import ml_dtypes

    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    return {"F32": x, "F16": x.astype(np.float16),
            "BF16": x.astype(ml_dtypes.bfloat16),
            "I8": rng.integers(-128, 128, (3, 5, 7)).astype(np.int8)}[dtype]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I8"])
def test_safetensors_round_trip_against_package(tmp_path, dtype):
    """Port writer -> safetensors.numpy.load_file, and save_file -> port
    reader, give the same bits; the reader's arrays are views of one map
    of the file, and its torch view gives BF16 as torch.bfloat16."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(3)
    tensors = {"a.weight": _array(dtype, rng), "b": _array(dtype, rng)[0],
               "empty": _array(dtype, rng)[:0]}
    ours = tmp_path / "ours.safetensors"
    PIO.write_safetensors(ours, tensors, metadata={"format": "pt"})
    got = load_file(str(ours))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(v))
        assert got[k].shape == v.shape

    theirs = tmp_path / "theirs.safetensors"
    save_file(tensors, str(theirs))
    read = PIO.read_safetensors(theirs)
    assert set(read) == set(tensors)
    for k, v in tensors.items():
        np.testing.assert_array_equal(read[k], _bits(v))
        if read[k].size:
            assert isinstance(read[k], np.memmap)
    as_torch = PIO.read_safetensors_torch(theirs)
    want_dtype = PIO.ST_DTYPES[dtype][1]
    for k, v in tensors.items():
        assert as_torch[k].dtype == want_dtype
        np.testing.assert_array_equal(
            _bits(as_torch[k].view(torch.int16).numpy()
                  if dtype == "BF16" else as_torch[k].numpy()), _bits(v))


def test_writer_takes_torch_tensors(tmp_path):
    """A torch tensor (bf16 included) writes the bits the package reads."""
    from safetensors.numpy import load_file

    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    tensors = {"f32": x, "bf16": x.to(torch.bfloat16),
               "t": x.T, "i8": (x * 30).to(torch.int8)}
    path = tmp_path / "t.safetensors"
    PIO.write_safetensors(path, tensors)
    got = load_file(str(path))
    for k, v in tensors.items():
        want = (v.contiguous().view(torch.int16) if v.dtype == torch.bfloat16
                else v.contiguous()).numpy()
        np.testing.assert_array_equal(_bits(got[k]), want)
    assert {k: v.dtype for k, v in PIO.read_safetensors_torch(path).items()
            } == {k: v.dtype for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# a tiny HF checkpoint directory
# ---------------------------------------------------------------------------


def _vocab_files(d):
    """vocab.json + merges.txt in the multilingual layout: 50,257 base
    entries (real merges learned from a multilingual corpus, then
    fillers), <|endoftext|> at 50,257."""
    from whisper_aries_tpu.decoding.tokenizer import _bytes_to_unicode

    b2u = _bytes_to_unicode()
    merges = train_bpe(CORPUS, 120)
    vocab_list = [b2u[i] for i in range(256)] + ["".join(m) for m in merges]
    vocab_list += [f"Ġfiller{i:05d}x"
                   for i in range(50257 - len(vocab_list))]
    vocab_list += ["<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab_list)}, ensure_ascii=False),
        encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
        encoding="utf-8")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """config.json, model.safetensors (a tiny random
    WhisperForConditionalGeneration at the large-v3 vocabulary and 128
    mels, saved by the safetensors package from transformers' state
    dict), generation_config.json with alignment heads, tokenizer files."""
    from safetensors.numpy import save_file
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    d = tmp_path_factory.mktemp("torch_ckpt") / "whisper-tiny-v3"
    d.mkdir()
    cfg = WhisperConfig(
        vocab_size=51866, num_mel_bins=128, d_model=32,
        encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=448)
    torch.manual_seed(11)
    model = WhisperForConditionalGeneration(cfg).eval()
    cfg.to_json_file(str(d / "config.json"))
    sd = {k: v.detach().cpu().numpy().copy()
          for k, v in model.state_dict().items()}
    save_file(sd, str(d / "model.safetensors"))
    (d / "generation_config.json").write_text(
        json.dumps({"alignment_heads": [list(h) for h in HEADS]}))
    _vocab_files(d)
    return d


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def test_load_model_matches_jax(checkpoint):
    """The port's tree equals params_from_jax of the JAX load_model's,
    bit for bit in f32; dims, model_dir and the alignment heads agree."""
    from whisper_aries_tpu.models import loader as JL

    from torch_port_util import to_numpy

    jparams, jdims, jdir = JL.load_model(str(checkpoint))
    params, dims, model_dir = TL.load_model(str(checkpoint))
    assert model_dir == jdir == str(checkpoint)
    assert dims == TW.WhisperDims(*[getattr(jdims, f)
                                    for f in jdims.__dataclass_fields__])
    assert dims.n_vocab == 51866 and dims.n_mels == 128
    _assert_trees_equal(params, TW.params_from_jax(to_numpy(jparams)))
    assert TL.load_alignment_heads(model_dir) == HEADS
    assert TL.load_alignment_heads(model_dir) == JL.load_alignment_heads(jdir)


def test_load_model_casts_on_device(checkpoint):
    """dtype bf16: every leaf is the f32 leaf cast to bf16."""
    params, _, _ = TL.load_model(str(checkpoint))
    p16, _, _ = TL.load_model(str(checkpoint), dtype=torch.bfloat16)
    want = {k: v.to(torch.bfloat16) for k, v in _leaves(params)}
    got = dict(_leaves(p16))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k])


def test_convert_accepts_bare_whisper_model_keys(checkpoint):
    """A bare WhisperModel state dict (keys without "model.") converts to
    the same tree; hf_state_dict inverts the conversion on the full key
    set (the tied proj_out aside)."""
    sd = PIO.read_safetensors_torch(checkpoint / "model.safetensors")
    dims = TW.dims_from_hf_config(json.loads(
        (checkpoint / "config.json").read_text()))
    full = TW.convert_hf_state_dict(sd, dims)
    bare = {k[len("model."):]: v for k, v in sd.items()
            if k.startswith("model.")}
    _assert_trees_equal(TW.convert_hf_state_dict(bare, dims), full)
    back = TW.hf_state_dict(full, dims)
    assert set(back) == set(sd) - {"proj_out.weight"}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_load_model_without_a_checkpoint(tmp_path):
    """No checkpoint: FileNotFoundError, as in the JAX package, unless
    allow_random (seeded random weights at the preset's dims, no
    model_dir)."""
    from whisper_aries_tpu.models import loader as JL

    for load in (TL.load_model, JL.load_model):
        with pytest.raises(FileNotFoundError, match="no local checkpoint"):
            load("tiny", cache_dir=str(tmp_path))
    params, dims, model_dir = TL.load_model("tiny", cache_dir=str(tmp_path),
                                            allow_random=True)
    assert model_dir is None and dims == TW.PRESETS["tiny"]
    assert params["decoder"]["tok_emb"].shape == (51865, 384)
    assert TL.load_alignment_heads(model_dir) is None


def test_resolve_model_dir_under_cache_dir(checkpoint, tmp_path):
    """A name resolves as a path, then under cache_dir as {name} and
    whisper-{name}."""
    shutil.copytree(checkpoint, tmp_path / "whisper-v3test")
    assert TL.resolve_model_dir("v3test", str(tmp_path)) == \
        tmp_path / "whisper-v3test"
    assert TL.resolve_model_dir(str(checkpoint)) == checkpoint
    assert TL.resolve_model_dir("absent", str(tmp_path)) is None


# ---------------------------------------------------------------------------
# the engine from the checkpoint directory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_ckpt_wav") / "speech.wav")
    write_wav(path, speechy_audio(35.0, seed=9), SR)
    return path


def _engines(checkpoint, **kw):
    from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
    from whisper_aries_tpu_torch.pipeline.engine import (
        AriesTranscriber as TEngine,
    )

    kw = dict(windows_per_device=1, **kw)
    return (JEngine(model_size=str(checkpoint), **kw),
            TEngine(model_size=str(checkpoint), device="cpu", **kw))


def test_engine_from_checkpoint(checkpoint):
    """The checkpoint's tokenizer with the special-token layout of its
    vocabulary (JAX's), its alignment heads, and the smoke test passing."""
    jeng, teng = _engines(checkpoint)
    assert teng.model_dir == jeng.model_dir == str(checkpoint)
    sp = teng.tokenizer.specials
    assert asdict(sp) == asdict(jeng.tokenizer.specials)
    assert (sp.n_vocab, sp.eot, sp.sot, sp.transcribe, sp.timestamp_begin,
            sp.num_languages) == (51866, 50257, 50258, 50360, 50365, 100)
    assert teng.alignment_heads == jeng.alignment_heads == HEADS
    for text in ("hello world", "مرحبا بالعالم", "emoji 😀 12345"):
        assert teng.tokenizer.encode(text) == jeng.tokenizer.encode(text)
    teng.smoke_test()


def test_engine_repairs_tokenizer_layout(checkpoint, tmp_path):
    """A vocab.json without the 50,257-entry base table (no fillers) lays
    its specials out after its own base; the engine repairs the layout
    from the model's vocabulary, as the JAX engine does."""
    d = tmp_path / "whisper-short-vocab"
    shutil.copytree(checkpoint, d)
    vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
    vocab = {t: i for t, i in vocab.items() if "filler" not in t}
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                  encoding="utf-8")
    (d / "generation_config.json").unlink()
    from whisper_aries_tpu_torch.decoding.tokenizer import WhisperTokenizer

    assert WhisperTokenizer.from_pretrained(str(d)).specials.n_vocab != 51866
    jeng, teng = _engines(d)
    assert asdict(teng.tokenizer.specials) == asdict(jeng.tokenizer.specials)
    assert teng.tokenizer.specials.n_vocab == 51866
    assert teng.tokenizer.specials.eot == 50257
    assert teng.alignment_heads is None and jeng.alignment_heads is None


def test_engine_corrupt_checkpoint_fails_fast(checkpoint, tmp_path,
                                              monkeypatch):
    """NaN weights fail at construction through the smoke test, in both
    packages; ARIES_SMOKE_TEST=0 skips it."""
    from safetensors.numpy import load_file, save_file

    from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
    from whisper_aries_tpu_torch.pipeline.engine import (
        AriesTranscriber as TEngine,
    )

    bad = tmp_path / "whisper-corrupt"
    shutil.copytree(checkpoint, bad)
    sd = load_file(str(bad / "model.safetensors"))
    key = "model.encoder.layers.0.self_attn.q_proj.weight"
    sd[key] = np.full_like(sd[key], np.nan)
    save_file(sd, str(bad / "model.safetensors"))
    with pytest.raises(RuntimeError, match="smoke test failed"):
        TEngine(model_size=str(bad), device="cpu", windows_per_device=1)
    with pytest.raises(RuntimeError, match="smoke test failed"):
        JEngine(model_size=str(bad), windows_per_device=1)
    monkeypatch.setenv("ARIES_SMOKE_TEST", "0")
    eng = TEngine(model_size=str(bad), device="cpu", windows_per_device=1)
    with pytest.raises(RuntimeError, match="smoke test failed"):
        eng.smoke_test()


def test_engine_without_checkpoint_raises(tmp_path):
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    with pytest.raises(FileNotFoundError, match="no local checkpoint"):
        AriesTranscriber(model_size="tiny", device="cpu",
                         cache_dir=str(tmp_path))


@pytest.mark.parametrize("language", [None, "en"])
def test_transcribe_file_from_checkpoint_matches_jax(checkpoint, wav,
                                                     tmp_path, language):
    """The same text and tokens as the JAX engine on the same directory,
    with the same timestamps (the real tokenizer decodes)."""
    jeng, teng = _engines(checkpoint)
    call = dict(language=language, temperature=(0.0,), max_new_tokens=24,
                output_formats=("txt", "srt"))
    want = jeng.transcribe_file(wav, output_dir=str(tmp_path / "jax"), **call)
    got = teng.transcribe_file(wav, output_dir=str(tmp_path / "torch"),
                               **call)
    assert got["num_windows"] == want["num_windows"] >= 2
    assert got["language"] == want["language"]
    seg = lambda r: [(s["text"], s["start"], s["end"], list(s["tokens"]))
                     for s in r["segments"]]
    assert seg(got) == seg(want) and got["segments"]
    assert got["text"] == want["text"]
    for fmt in ("txt", "srt"):
        with open(got["output_files"][fmt], "rb") as a, \
                open(want["output_files"][fmt], "rb") as b:
            assert a.read() == b.read()

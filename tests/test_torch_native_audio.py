"""The port's native audio runtime (whisper_aries_tpu_torch/audio/_native.py
over its own C++ in whisper_aries_tpu_torch/native/) against the JAX
package's (whisper_aries_tpu/audio/_native.py over native/), on the CPU.

Tolerance: none. Every decode and every resample is held bit for bit
against the JAX package's native counterpart on the same bytes; the JAX
side is asserted to have its native library first, so it can never be
its numpy fallback. It mirrors tests/test_audio.py's WAV, resampler and
codec cases, adds garbage input and a missing system library, and runs a
44.1 kHz stereo FLAC through both engines' transcribe_file."""

import struct

import numpy as np
import pytest

from torch_port_util import jax_native_library
from whisper_aries_tpu.audio import _native as jn
from whisper_aries_tpu.audio import decode as jd
from whisper_aries_tpu_torch.audio import _native as tn
from whisper_aries_tpu_torch.audio import decode as td
from whisper_aries_tpu_torch.errors import AudioError

SR = 16_000


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native library, so its side is never its numpy
    fallback."""
    jax_native_library()


def wav_bytes(x, sr, bits=16, fmt=1):
    """WAV bytes of ``x`` ((n,) mono or (n, channels)) in any PCM flavour:
    s16 / s24 / s32 (fmt 1), f32 / f64 (fmt 3)."""
    x = np.asarray(x, np.float64)
    channels = 1 if x.ndim == 1 else x.shape[1]
    inter = np.clip(x.reshape(-1), -1, 1)
    if fmt == 1 and bits == 16:
        pcm = (inter * 32767).astype("<i2").tobytes()
    elif fmt == 1 and bits == 24:
        v = (inter * 8388607).astype("<i4").tobytes()
        pcm = np.frombuffer(v, np.uint8).reshape(-1, 4)[:, :3].tobytes()
    elif fmt == 1 and bits == 32:
        pcm = (inter * 2147483647).astype("<i4").tobytes()
    elif fmt == 3 and bits == 32:
        pcm = inter.astype("<f4").tobytes()
    elif fmt == 3 and bits == 64:
        pcm = inter.astype("<f8").tobytes()
    else:
        raise ValueError((bits, fmt))
    align = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, sr,
                                 sr * align, align, bits)
    return hdr + b"data" + struct.pack("<I", len(pcm)) + pcm


def signal(seconds, sr, channels=1, seed=0):
    """A 440 Hz tone at 0.3 with noise at 0.05 (the shape of audio whose
    resampling the port once computed differently)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    cols = [0.3 * np.sin(2 * np.pi * (440 + 110 * c) * t)
            + 0.05 * rng.standard_normal(len(t)) for c in range(channels)]
    x = np.stack(cols, axis=1)
    return x[:, 0] if channels == 1 else x


def same(got, want):
    """Bit for bit: the same dtype, shape and bytes."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# WAV and the resampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits,fmt", [(16, 1), (24, 1), (32, 1), (32, 3),
                                      (64, 3)],
                         ids=["s16", "s24", "s32", "f32", "f64"])
@pytest.mark.parametrize("sr", [8000, 22050, 44100, 48000])
def test_wav_decode_and_resample_bit_identical(sr, bits, fmt, channels):
    data = wav_bytes(signal(0.5, sr, channels), sr, bits, fmt)
    got, gsr = tn.decode_wav(data)
    want, wsr = jn.decode_wav_native(data)
    assert gsr == wsr == sr
    same(got, want)
    same(td.decode_wav_bytes(data)[0], jd.decode_wav_bytes(data)[0])
    same(td.resample(got, sr, SR), jn.resample_native(want, sr, SR))
    same(td.resample(got, sr, SR), jd.resample(want, sr, SR))


@pytest.mark.parametrize("sr_in,sr_out", [(8000, 16000), (22050, 16000),
                                          (44100, 16000), (48000, 16000),
                                          (16000, 44100), (16000, 16000)])
def test_resampler_bit_identical_on_noise(sr_in, sr_out):
    x = (0.1 * np.random.default_rng(3).standard_normal(sr_in)).astype(
        np.float32)
    same(td.resample(x, sr_in, sr_out), jd.resample(x, sr_in, sr_out))


def test_load_audio_441_stereo_bit_identical(tmp_path):
    """The repair: a 44.1 kHz stereo WAV loads to the same samples in both
    packages (the port once resampled it by numpy, up to 0.015 apart)."""
    path = tmp_path / "stereo.wav"
    path.write_bytes(wav_bytes(signal(4.0, 44100, 2), 44100, 16, 1))
    got = td.load_audio(str(path))
    same(got, jd.load_audio(str(path)))
    assert len(got) == 64000
    pre = td.AudioPreloader(str(path))
    assert pre.audio_i16 is None and pre.duration == 4.0
    same(pre.audio, got)


def test_preloader_keeps_pcm16_mono_samples(tmp_path):
    x = signal(1.0, SR)
    path = tmp_path / "mono.wav"
    td.write_wav(str(path), x, SR)
    pre, jpre = td.AudioPreloader(str(path)), jd.AudioPreloader(str(path))
    same(pre.audio_i16, jpre.audio_i16)
    same(pre.audio, jpre.audio)
    same(pre.audio, td.load_audio(str(path)))
    assert pre.duration == jpre.duration == 1.0
    same(pre.get_chunk(0.25, 0.5), jpre.get_chunk(0.25, 0.5))
    assert td.peek_wav_s16_mono(wav_bytes(x, 22050)) is None


@pytest.mark.parametrize("sr_in", [8000, 22050, 44100, 48000])
def test_resampler_keeps_a_sine(sr_in):
    """tests/test_audio.py's quality bar: a 1 kHz sine through the port's
    resampler at more than 60 dB SNR away from the edges."""
    t = np.arange(sr_in, dtype=np.float64) / sr_in
    y = td.resample(np.sin(2 * np.pi * 1000 * t).astype(np.float32), sr_in)
    assert abs(len(y) - SR) <= 2
    ref = np.sin(2 * np.pi * 1000 * np.arange(len(y)) / SR)
    core = slice(400, len(y) - 400)
    err = y[core] - ref[core]
    assert 10 * np.log10(np.mean(ref[core] ** 2) / np.mean(err ** 2)) > 60


# ---------------------------------------------------------------------------
# FLAC, MP3, Ogg/Vorbis, m4a
# ---------------------------------------------------------------------------

def _pcm(seconds, sr, seed=0, amp=20000):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return (amp * np.sin(2 * np.pi * 440 * t)
            + 300 * rng.standard_normal(len(t))).astype(np.int64)


@pytest.mark.parametrize("mode,order,channels,sr", [
    ("verbatim", 0, 1, 16000), ("fixed", 1, 1, 16000),
    ("fixed", 2, 2, 44100), ("constant", 0, 1, 16000),
    ("lpc", 0, 1, 16000), ("lpc", 0, 2, 48000)])
def test_flac_bit_identical(mode, order, channels, sr, tmp_path):
    from tests.flac_encoder import encode_flac

    chans = [np.full(7000, 1234, np.int64)] if mode == "constant" else [
        _pcm(0.4, sr, seed=c) for c in range(channels)]
    data = encode_flac(chans, sample_rate=sr, mode=mode, order=order,
                       block_size=3000)
    got, gsr = tn.decode_flac(data)
    want, wsr = jn.decode_flac_native(data)
    assert gsr == wsr == sr
    same(got, want)
    np.testing.assert_array_equal(got, sum(chans) / channels / 32768.0)
    path = tmp_path / "a.flac"
    path.write_bytes(data)
    same(td.load_audio(str(path)), jd.load_audio(str(path)))


def test_mp3_bit_identical(tmp_path):
    from tests.mp3_encoder import encode_mp3, lame_available

    if not (tn.codec_available("mp3") and lame_available()):
        pytest.skip("libmpg123 or libmp3lame does not resolve here")
    assert jn.mp3_available()
    for sr in (16000, 44100):
        data = encode_mp3(signal(1.5, sr).astype(np.float32), sr)
        got, gsr = tn.decode_mp3(data)
        want, wsr = jn.decode_mp3_native(data)
        assert gsr == wsr == sr
        same(got, want)
        path = tmp_path / f"a{sr}.mp3"
        path.write_bytes(data)
        same(td.load_audio(str(path)), jd.load_audio(str(path)))


def test_ogg_bit_identical(tmp_path):
    if not tn.codec_available("ogg"):
        pytest.skip("libvorbisfile does not resolve here")
    assert jn.ogg_available()
    for sr in (16000, 44100):
        data = tn.encode_ogg(signal(1.5, sr), sr)
        assert data[:4] == b"OggS"
        got, gsr = tn.decode_ogg(data)
        want, wsr = jn.decode_ogg_native(data)
        assert gsr == wsr == sr
        same(got, want)
        assert len(got) == int(1.5 * sr)  # vorbis is sample-exact
        path = tmp_path / f"a{sr}.ogg"
        path.write_bytes(data)
        same(td.load_audio(str(path)), jd.load_audio(str(path)))


@pytest.mark.parametrize("ext", [".m4a", ".mp4"])
def test_av_bit_identical(ext, tmp_path):
    if not tn.codec_available("av"):
        pytest.skip("libavformat does not resolve here")
    assert jn.av_available()
    for sr in (16000, 44100):
        data = tn.encode_m4a(signal(1.5, sr), sr)
        assert data[4:8] == b"ftyp"
        got, gsr = tn.decode_av(data)
        want, wsr = jn.decode_av_native(data)
        assert gsr == wsr == sr
        same(got, want)
        path = tmp_path / f"a{sr}{ext}"
        path.write_bytes(data)
        same(td.load_audio(str(path)), jd.load_audio(str(path)))


# ---------------------------------------------------------------------------
# errors: garbage input, a missing system library, no fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,body,match", [
    (".wav", b"not a wav file at all", "not a RIFF/WAVE"),
    (".wav", b"RIFF\x10\x00\x00\x00WAVEjunkjunk", "fmt"),
    (".flac", b"definitely not a flac stream", "FLAC"),
    (".mp3", b"\x00\x01nonsense" * 100, "MP3"),
    (".ogg", b"OggS....but not really a stream" * 50, "OGG"),
    (".m4a", b"\x00\x00\x00 ftypM4A but not really" * 100, "ffmpeg"),
])
def test_garbage_raises_audio_error(ext, body, match, tmp_path):
    kind = {".mp3": "mp3", ".ogg": "ogg", ".m4a": "av"}.get(ext)
    if kind and not tn.codec_available(kind):
        pytest.skip(f"{tn.CODEC_LIBRARIES[kind]} does not resolve here")
    path = tmp_path / f"junk{ext}"
    path.write_bytes(body)
    with pytest.raises(AudioError, match=match):
        td.load_audio(str(path))


@pytest.mark.parametrize("ext,kind", [(".mp3", "mp3"), (".ogg", "ogg"),
                                      (".oga", "ogg"), (".m4a", "av"),
                                      (".webm", "av")])
def test_missing_system_library_is_named(ext, kind, tmp_path, monkeypatch):
    """A codec whose system library does not resolve raises AudioError
    naming the library, and nothing else is tried."""
    path = tmp_path / f"a{ext}"
    path.write_bytes(b"\x00" * 64)
    monkeypatch.setattr(tn, "codec_available", lambda k: k != kind)
    monkeypatch.setattr(td, "_ffmpeg_wav", lambda *a: pytest.fail("tried"))
    with pytest.raises(AudioError, match=tn.CODEC_LIBRARIES[kind]):
        td.load_audio(str(path))


def test_av_not_built_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(tn, "av_built", lambda: False)
    monkeypatch.setattr(tn, "codec_available", lambda k: k != "av")
    path = tmp_path / "a.m4a"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(AudioError, match="libavformat: its headers"):
        td.load_audio(str(path))


def test_missing_file_and_failed_build(tmp_path, monkeypatch):
    with pytest.raises(AudioError, match="not found"):
        td.load_audio(str(tmp_path / "none.wav"))
    # a failed compile raises with the compiler's output
    monkeypatch.setattr(tn, "LIB_PATH", tmp_path / "libariesaudio.so")
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tn, "sources", lambda: [tmp_path / "broken.cpp"])
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        tn.build()
    assert list(tmp_path.glob("*.so")) == []


def test_library_is_the_ports_own_build():
    """The port builds its library from its own sources into its _build/
    and never from or into the JAX package's directories."""
    import os

    port = os.path.dirname(os.path.dirname(os.path.abspath(tn.__file__)))
    assert tn.LIB_PATH.parent == tn.BUILD_DIR
    assert str(tn.BUILD_DIR) == os.path.join(port, "_build")
    assert all(str(s).startswith(os.path.join(port, "native") + os.sep)
               for s in tn.sources())
    tn.library()
    assert not tn._stale()
    with open("/proc/self/maps") as f:
        maps = [l.split()[-1] for l in f if "libariesaudio" in l]
    assert str(tn.LIB_PATH) in maps


# ---------------------------------------------------------------------------
# the slice: a 44.1 kHz stereo FLAC through both engines
# ---------------------------------------------------------------------------

def test_flac_441_stereo_transcribe_file_matches_jax_engine(tmp_path):
    from tests.flac_encoder import encode_flac
    from torch_port_util import (
        PieceTokenizer,
        random_jax_tree,
        speechy_audio,
        to_jax,
    )
    from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
    from whisper_aries_tpu.models import whisper as JW
    from whisper_aries_tpu.parallel.mesh import make_mesh
    from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
    from whisper_aries_tpu_torch.models import whisper as TW
    from whisper_aries_tpu_torch.pipeline.engine import (
        AriesTranscriber as TEngine,
    )

    sr = 44100
    x = speechy_audio(35.0, seed=5, sr=sr)
    left = np.round(np.clip(x, -1, 1) * 32767).astype(np.int64)
    right = np.round(np.clip(0.8 * x[::-1], -1, 1) * 32767).astype(np.int64)
    path = tmp_path / "scene.flac"
    path.write_bytes(encode_flac([left, right], sample_rate=sr, mode="lpc",
                                 block_size=4096))
    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    kw = dict(windows_per_device=1, _tokenizer=tok)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, mesh=make_mesh(1), **kw)
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dims_t, **kw)
    call = dict(temperature=(0.0,), max_new_tokens=16, output_formats=(),
                vad_filter=False)
    want = jeng.transcribe_file(str(path), **call)
    got = teng.transcribe_file(str(path), **call)
    assert got["duration"] == want["duration"] == 35.0
    assert got["num_windows"] == want["num_windows"] == 2
    assert [s["tokens"] for s in got["segments"]] == \
        [s["tokens"] for s in want["segments"]]
    assert [(s["text"], s["start"], s["end"]) for s in got["segments"]] == \
        [(s["text"], s["start"], s["end"]) for s in want["segments"]]
    assert got["segments"]

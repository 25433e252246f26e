"""One decode replica a card (whisper_aries_tpu_torch/parallel/mesh.py and
the engine's ``mesh``) against the JAX package's mesh, on the CPU; and
the four engine repairs against the JAX engine:

  * the port engine over 4 CPU replicas against the JAX engine on
    ``make_mesh(4)`` of the 8 virtual CPU devices, greedy and beam 5, on
    a file of 5 windows at one a device (a batch of 4, divisible by 4,
    and one of 1):
    equal segments (text, tokens, times within 1e-6 s), ``worker_id``
    (a window's row in its batch modulo the devices), the batch size
    (devices × windows_per_device), and the ``performance`` report's keys,
    units, audio seconds and units a device;
  * ``beam_search_decode_sharded`` against the JAX function on 4
    devices, with ``prompt_start`` and ``row_lang`` (which JAX drops:
    its prompt carries the languages instead): equal tokens;
  * launch counts exact under 4 threads, and a graph capture's record
    kept to its own thread;
  * an out-of-memory error halves the batch once, in both engines.

Temperature is pinned to (0.0,): the sampled rungs of the fallback ladder
draw from different generators in the two frameworks."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import PieceTokenizer, random_jax_tree, speechy_audio, to_jax
from whisper_aries_tpu.decoding import generate as JG
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.parallel.mesh import make_mesh as jax_mesh
from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.parallel import mesh as TM
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine

SR = 16_000
KW = dict(temperature=(0.0,), max_new_tokens=8, output_formats=(),
          vad_filter=False, language="en")


@pytest.fixture(scope="module")
def model():
    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    return tok, dims_j, dims_t, tree


def _engines(model, n, **kw):
    """The JAX engine on ``make_mesh(n)`` and the port's over ``n`` CPU
    replicas, both at ``windows_per_device`` windows a device (default
    1)."""
    tok, dims_j, dims_t, tree = model
    kw = dict(dict(windows_per_device=1, _tokenizer=tok), **kw)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, mesh=jax_mesh(n), **kw)
    teng = TEngine(model_size="tiny-torch", _params=TW.params_from_jax(tree),
                   _dims=dims_t, mesh=TM.make_mesh(devices=["cpu"] * n),
                   **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def engines4(model):
    return _engines(model, 4)


@pytest.fixture(scope="module")
def wav5(tmp_path_factory):
    """5 windows of 30 s with VAD off: batches of 4 and 1."""
    path = str(tmp_path_factory.mktemp("torch_mesh") / "long.wav")
    write_wav(path, speechy_audio(140.0, seed=5), SR)
    return path


def _segments(res):
    return [(s["text"], list(s["tokens"]), s["window_id"], s["worker_id"])
            for s in res["segments"]]


def _times(res):
    return np.asarray([(s["start"], s["end"]) for s in res["segments"]],
                      np.float64).reshape(-1, 2)


REPORT = ("completed_units", "completed_audio_s", "per_device_distribution")


def _assert_same(got, want):
    assert got["num_windows"] == want["num_windows"]
    assert _segments(got) == _segments(want) and got["segments"]
    np.testing.assert_allclose(_times(got), _times(want), atol=1e-6, rtol=0)
    assert set(got["performance"]) == set(want["performance"])
    for k in REPORT:
        assert got["performance"][k] == pytest.approx(want["performance"][k])


@pytest.mark.parametrize("beam_size", [1, 5])
def test_four_replicas_match_the_jax_mesh(engines4, wav5, beam_size):
    """5 windows at 1 a device: a batch of 4 (every device one) and one of
    1 (device 0); the segments, each one's worker_id, and the report's two
    units, one on device 0 and one on device 1."""
    jeng, teng = engines4
    assert teng.batch_size == jeng.batch_size == 4
    want = jeng.transcribe_file(wav5, beam_size=beam_size, **KW)
    got = teng.transcribe_file(wav5, beam_size=beam_size, **KW)
    assert got["num_windows"] == 5
    _assert_same(got, want)
    assert got["performance"]["per_device_distribution"] == {0: 1, 1: 1}
    assert {s["worker_id"] for s in got["segments"]} == {0, 1, 2, 3}
    # every shard's decode was its own call, on its own replica's weights
    decodes = teng.last_stats["decodes"]
    assert [d["windows"] for d in decodes] == [1] * 5
    assert all(d["beam_size"] == beam_size for d in decodes)


def test_one_device_report_matches_jax(model, tmp_path):
    """Repairs (a)-(c) on one device: ``performance`` is the JAX report
    (its keys; units, audio seconds and units a device equal), every
    worker_id 0, the batch windows_per_device."""
    tok, dims_j, dims_t, tree = model
    jeng, teng = _engines(model, 1, windows_per_device=2)
    path = str(tmp_path / "short.wav")
    write_wav(path, speechy_audio(100.0, seed=3), SR)
    want = jeng.transcribe_file(path, **KW)
    got = teng.transcribe_file(path, **KW)
    assert teng.batch_size == jeng.batch_size == 2
    _assert_same(got, want)
    assert got["performance"]["completed_units"] == 2
    assert {s["worker_id"] for s in got["segments"]} == {0}
    assert "decodes" not in got["performance"]
    assert teng.last_stats["encodes"] == {1500: 4}


def test_sequential_mode_has_no_report(engines4, tmp_path):
    """condition_on_previous_text decodes window by window on the first
    replica: no batch, so ``performance`` is None in both engines, and
    every segment's worker_id is 0."""
    jeng, teng = engines4
    path = str(tmp_path / "two.wav")
    write_wav(path, speechy_audio(50.0, seed=4), SR)
    kw = dict(KW, condition_on_previous_text=True)
    want = jeng.transcribe_file(path, **kw)
    got = teng.transcribe_file(path, **kw)
    assert got["performance"] is None and want["performance"] is None
    assert _segments(got) == _segments(want) and got["segments"]
    assert {s["worker_id"] for s in got["segments"]} == {0}


def test_oom_halves_the_batch_once(model, wav5, monkeypatch):
    """Repair (d): the batch loop catches with is_oom_error. Every
    replica's shard raising the runtime's "CUDA out of memory" spelling
    halves the batch once (4 -> 2), as the JAX engine halves on an XLA
    RESOURCE_EXHAUSTED; the retried batches give the JAX engine's
    segments."""
    monkeypatch.setenv("ARIES_PIPELINE", "0")  # JAX: no depth rung first
    jeng, teng = _engines(model, 4)
    failed = {"jax": 0, "torch": 0}

    def flaky(eng, name, msg):
        real = eng._decode_batch

        def decode(*a, **k):
            if failed[name] < (4 if name == "torch" else 1):
                failed[name] += 1
                raise RuntimeError(msg)
            return real(*a, **k)

        return decode

    monkeypatch.setattr(jeng, "_decode_batch", flaky(
        jeng, "jax", "RESOURCE_EXHAUSTED: Out of memory while trying to "
        "allocate 1.2G"))
    for r in teng.replicas:
        monkeypatch.setattr(r, "_decode_batch", flaky(
            teng, "torch", "CUDA out of memory. Tried to allocate 1.2 GiB"))
    want = jeng.transcribe_file(wav5, **KW)
    got = teng.transcribe_file(wav5, **KW)
    assert failed == {"jax": 1, "torch": 4}
    assert teng.batch_size == jeng.batch_size == 2
    _assert_same(got, want)


def test_non_oom_errors_are_raised(model, wav5, monkeypatch):
    """A shard's error that is not out-of-memory reaches the caller and
    the batch is not halved."""
    _, teng = _engines(model, 4)

    def broken(*a, **k):
        raise ValueError("a kernel refused its arguments")

    for r in teng.replicas:
        monkeypatch.setattr(r, "_decode_batch", broken)
    with pytest.raises(ValueError, match="refused"):
        teng.transcribe_file(wav5, **KW)
    assert teng.batch_size == 4


def test_is_oom_error_spellings():
    from whisper_aries_tpu_torch.utils.memory import is_oom_error

    yes = [torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 20.00 MiB"),
           cb.CudaError("W8A16 GEMM", 2, "launch"),
           RuntimeError("CUDA error: out of memory"),
           RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
           RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when "
                        "calling cublasCreate(handle)")]
    no = [cb.CudaError("mel kernel", 1, "launch"), ValueError("out of memory"),
          RuntimeError("shape mismatch"), KeyError("memory")]
    assert all(is_oom_error(e) for e in yes)
    assert not any(is_oom_error(e) for e in no)


def test_beam_search_decode_sharded_matches_jax():
    """4 windows on 4 devices (one each), a left-padded prompt with
    ``prompt_start`` 2 and a language per window: the port's row_lang is
    written into its rows; JAX's function drops row_lang, so its prompt
    carries the same languages."""
    sp = build_special_tokens(24, 2)
    dims_j = JW.WhisperDims(80, 40, 128, 2, 2, sp.n_vocab, 448, 128, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    ids = dict(eot=sp.eot, sot=sp.sot, no_speech=sp.no_speech,
               no_timestamps=sp.no_timestamps,
               timestamp_begin=sp.timestamp_begin, blank=20,
               n_vocab=sp.n_vocab)
    tree = random_jax_tree(dims_j, seed=8, weight_std=0.08)
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((4, 80, 80)).astype(np.float32)
    xa = np.asarray(JW.encode(to_jax(tree), jnp.asarray(mel), dims_j))
    mask = np.zeros(sp.n_vocab, np.float32)
    mask[[sp.sot, sp.sot_prev, sp.no_speech, sp.transcribe]] = TG.NEG_INF
    seq = list(sp.sot_sequence("en"))
    prompt = np.asarray([[-1, -1] + seq] * 4, np.int32)
    langs = np.asarray([seq[1], seq[1] + 1, seq[1] + 1, seq[1]], np.int32)
    sot = 2
    jprompt = prompt.copy()
    jprompt[:, sot + 1] = langs
    kw = dict(beam_size=5, sample_len=10, kv_int8=True, self_kv_int8=False)
    want = JG.beam_search_decode_sharded(
        jax_mesh(4), JW.fuse_decoder_qkv(to_jax(tree)), jnp.asarray(xa),
        jnp.asarray(jprompt), dims_j, JG.DecodeSpecialIds(**ids),
        jnp.asarray(mask), jnp.int32(sot), prompt_start=jnp.int32(2),
        beam_reorder="xla", beam_tail="xla", beam_group=1, **kw)
    mesh = TM.make_mesh(devices=["cpu"] * 4)
    tparams = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    got = TG.beam_search_decode_sharded(
        mesh, TM.replicate_params(tparams, mesh), torch.from_numpy(xa.copy()),
        torch.from_numpy(prompt).long(), dims_t, TG.DecodeSpecialIds(**ids),
        torch.from_numpy(mask), sot, prompt_start=2,
        row_lang=torch.from_numpy(langs), **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["tokens"][:, sot + 1].numpy(), langs)
    np.testing.assert_allclose(got["sum_logprob"].numpy(),
                               np.asarray(want["sum_logprob"]), rtol=1e-4)
    # the same decode unsharded gives the same tokens
    one = TG.beam_search_decode(
        tparams, torch.from_numpy(xa.copy()),
        torch.from_numpy(jprompt).long(), dims_t, TG.DecodeSpecialIds(**ids),
        torch.from_numpy(mask), sot, prompt_start=2, **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), one["tokens"].numpy())


def test_launch_counts_exact_under_four_threads():
    """cb.count from 4 threads at once adds every launch (a plain ``+=``
    loses some); a thread inside cb.recording() keeps its launches in its
    own record while the others count."""
    def fn():
        pass

    fn.launches = 0
    fn.launches_by_path = {"a": 0, "b": 0}
    n = 20_000
    start = threading.Barrier(5)
    record = {}

    def counting(path):
        start.wait()
        for _ in range(n):
            cb.count(fn, path=path)

    def recording():
        start.wait()
        with cb.recording() as rec:
            for _ in range(n):
                cb.count(fn)
        record.update(rec)

    threads = [threading.Thread(target=counting, args=(p,))
               for p in ("a", "b", "a", None)]
    threads.append(threading.Thread(target=recording))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fn.launches == 4 * n
    assert fn.launches_by_path == {"a": 2 * n, "b": n}
    assert record == {(fn, None): n}
    cb.add_counts(record, times=2)
    assert fn.launches == 6 * n


def test_every_wrapper_counts_through_the_lock():
    """No module of the port adds to a launch counter with ``+=``: every
    count goes through cuda_build.count / bump / add_counts."""
    import re
    from pathlib import Path

    root = Path(TW.__file__).resolve().parents[1]
    bad = []
    for path in root.rglob("*.py"):
        if path.name == "cuda_build.py":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"\.(launches|graph_replays)(\[[^\]]*\])?\s*\+=",
                         line) or re.search(r"launches_by_path\[.*\+=", line):
                bad.append(f"{path.name}:{i}")
    assert not bad, bad


def test_mesh_helpers():
    mesh = TM.make_mesh(devices=["cpu"] * 4)
    assert mesh == [torch.device("cpu")] * 4
    assert TM.make_mesh(2, devices=["cpu"] * 4) == [torch.device("cpu")] * 2
    assert TM.shard_bounds(11, 4) == [(0, 3), (3, 6), (6, 9), (9, 11)]
    assert TM.shard_bounds(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    x = torch.arange(6 * 2).reshape(6, 2)
    parts = TM.shard_batch({"a": x}, mesh)
    assert [p["a"].shape[0] for p in parts] == [2, 2, 2, 0]
    assert torch.equal(torch.cat([p["a"] for p in parts]), x)
    tree = {"w": torch.ones(3), "blk": {"b": torch.zeros(2)}}
    reps = TM.replicate_params(tree, mesh)
    assert all(r is reps[0] for r in reps)  # one copy a distinct device
    padded, n = TM.pad_to_multiple(np.ones((5, 2)), 4)
    assert padded.shape == (8, 2) and n == 5 and padded[5:].sum() == 0
    tp, n = TM.pad_to_multiple(torch.ones(5, 2), 4)
    assert tp.shape == (8, 2) and n == 5
    order = []
    out = TM.map_shards(mesh, 6, lambda i, d, lo, hi: (
        order.append(threading.current_thread().name), (i, lo, hi))[1])
    assert out == [(0, 0, 2), (1, 2, 4), (2, 4, 6), None]
    assert sorted(order) == ["replica-0", "replica-1", "replica-2"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if not torch.cuda.is_available():
            TM.make_mesh()


def test_auto_windows_per_device_divides_free_memory():
    """The bytes a window holds (cross K/V, the rows' self cache with the
    prefill's transients, encoder activations) divide the free memory;
    no TPU anchor or clamp."""
    dims = TW.PRESETS["large-v3"]
    per = TM.window_bytes(dims, rows=5, cache_len=227)
    cross = 2 * 32 * 1280 * 1500 + 2 * 32 * 20 * 1500 * 4
    assert per > cross + 5 * 2 * 32 * 1280 * 227
    assert TM.auto_windows_per_device(free_bytes=40 * 10**9) == int(
        40 * 10**9 // per)
    assert TM.auto_windows_per_device(free_bytes=10**12) > 56
    assert TM.auto_windows_per_device(free_bytes=1) == 1
    # bf16 cross K/V and self cache hold more a window than int8
    assert TM.window_bytes(dims, kv_int8=False, self_kv_int8=False) != per

"""The port's public names: every name in each JAX subpackage's ``__all__``,
and the JAX package root's public names, resolve in the port's module of
the same name; the functions added for them behave as the JAX ones."""

import importlib
import pkgutil
import types

import numpy as np
import pytest
import torch

import whisper_aries_tpu as J


def _subpackages():
    return sorted(m.name for m in pkgutil.iter_modules(J.__path__)
                  if m.ispkg)


@pytest.mark.parametrize("sub", _subpackages())
def test_every_jax_all_name_resolves_in_the_port(sub):
    jm = importlib.import_module(f"whisper_aries_tpu.{sub}")
    tm = importlib.import_module(f"whisper_aries_tpu_torch.{sub}")
    missing = [n for n in getattr(jm, "__all__", []) if not hasattr(tm, n)]
    assert not missing, f"whisper_aries_tpu_torch.{sub} lacks {missing}"


def test_root_public_names_resolve_in_the_port():
    """Names the JAX root defines (a submodule of the JAX package must be
    a submodule of the port)."""
    import whisper_aries_tpu_torch as T

    want = [n for n in vars(J) if not n.startswith("_")]
    assert {"AriesConfig", "load_config", "AudioError"} <= set(want)
    missing = []
    for n in want:
        if isinstance(getattr(J, n), types.ModuleType):
            try:
                importlib.import_module(f"whisper_aries_tpu_torch.{n}")
            except ImportError:
                missing.append(n)
        elif not hasattr(T, n):
            missing.append(n)
    assert not missing, f"whisper_aries_tpu_torch lacks {missing}"
    assert T.__version__ == J.__version__


def test_print_config_masks_the_token(capsys):
    """As tests/test_config.py:59, and the same text as the JAX dump."""
    from whisper_aries_tpu import config as jc
    from whisper_aries_tpu_torch import config as tc

    text = tc.print_config(tc.AriesConfig(hf_token="secret"))
    assert "secret" not in text and "[decode]" in text
    assert text == jc.print_config(jc.AriesConfig(hf_token="secret"))
    assert "secret" not in capsys.readouterr().out


def test_write_default_config(tmp_path):
    """Both packages write the same file; an existing file is kept."""
    from whisper_aries_tpu import config as jc
    from whisper_aries_tpu_torch import config as tc

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert tc.write_default_config(str(a)) == str(a)
    jc.write_default_config(str(b))
    assert a.read_text() == b.read_text()
    cfg = tc.load_config(config_file=str(a))
    assert cfg.to_dict() == tc.AriesConfig().to_dict()
    a.write_text("{}")
    tc.write_default_config(str(a), tc.AriesConfig(hf_token="x"))
    assert a.read_text() == "{}"


@pytest.mark.parametrize("n", [0, 100, 480000, 500000])
def test_pad_or_trim_matches_jax(n):
    from whisper_aries_tpu.audio import pad_or_trim as jpad
    from whisper_aries_tpu_torch.audio import pad_or_trim

    x = np.random.default_rng(n).standard_normal(n).astype(np.float64)
    got, want = pad_or_trim(x), jpad(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pad_or_trim(x, 77), jpad(x, 77))


def test_dequantize_int8_matches_jax():
    import jax.numpy as jnp
    from whisper_aries_tpu.ops import quant as jq

    from whisper_aries_tpu_torch.ops import dequantize_int8, quantize_int8

    w = np.random.default_rng(0).standard_normal((2, 48, 24)).astype(
        np.float32)
    q, s = quantize_int8(torch.from_numpy(w))
    jqv, js = jq.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_int8(q, s, dt)
        want = np.asarray(jq.dequantize_int8(jqv, js, jdt)).astype(
            np.float32)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_reference_class_name_is_the_engine():
    from whisper_aries_tpu_torch.pipeline import (
        AriesTranscriber,
        OptimizedParallelTranscriber,
    )

    assert OptimizedParallelTranscriber is AriesTranscriber

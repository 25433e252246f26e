"""Which vocab product the port's teacher-forced passes run
(whisper_aries_tpu_torch.models.whisper): ``decoder_forward``,
``alignment_forward`` and language detection
(``decoding.generate.detect_language_batched``) take the final LayerNorm
and product through ``vocab_logits_step`` (``ops/vocab.py::
vocab_product``, the vocab kernel on the card) unless autograd needs the
product, and keep ``vocab_logits``'s bits on the CPU; a training loss still
differentiates through ``vocab_logits``. Each is held against the JAX
package on the same numpy-seeded inputs at the tolerances of the tests that
already hold it (tests/test_torch_whisper.py, test_torch_word_align.py,
test_torch_generate.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import random_jax_tree, to_jax
from whisper_aries_tpu.align import word_align as JA
from whisper_aries_tpu.decoding import generate as JG
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.pipeline import train as TT

SP = build_special_tokens(24, 2)  # 24 text pieces, 2 languages
# d 128 = 2 heads x dh 64, 2 + 2 layers, 40 audio positions
DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, SP.n_vocab, 448, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])
LANG0 = min(SP.language_tokens.values())


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, encoder output, tokens) in f32."""
    tree = random_jax_tree(DIMS_J, seed=31, weight_std=0.08)
    jp = to_jax(tree)
    tp = TW.params_from_jax(tree)
    rng = np.random.default_rng(32)
    mel = rng.standard_normal((3, 80, 80)).astype(np.float32)
    xa = np.asarray(JW.encode(jp, jnp.asarray(mel), DIMS_J))
    toks = rng.integers(0, 24, (3, 7))
    toks[1, 5:] = SP.eot  # eot padding past a shorter window
    return jp, tp, xa, toks


def _counting(monkeypatch):
    """Count the calls of the port's vocab_product and of vocab_logits."""
    calls = {"product": 0, "logits": 0}
    product, logits = TW.vocab_product, TW.vocab_logits

    def counted_product(x, emb):
        calls["product"] += 1
        return product(x, emb)

    def counted_logits(dec, x):
        calls["logits"] += 1
        return logits(dec, x)

    monkeypatch.setattr(TW, "vocab_product", counted_product)
    monkeypatch.setattr(TW, "vocab_logits", counted_logits)
    return calls


def _run(name, tp, xa, toks):
    xa_t = torch.from_numpy(xa.copy())
    if name == "decoder_forward":
        return TW.decoder_forward(tp, torch.from_numpy(toks), xa_t, DIMS_T)
    if name == "alignment_forward":
        sel, _ = JA._alignment_head_onehot(DIMS_J, [(1, 0), (1, 1), (0, 1)])
        return TW.alignment_forward(tp, torch.from_numpy(toks), xa_t, sel,
                                    DIMS_T)
    return TG.detect_language_batched(tp, xa_t, DIMS_T, SP.sot, LANG0, 2)


def _jax(name, jp, xa, toks):
    if name == "decoder_forward":
        return np.asarray(JW.decoder_forward(
            jp, jnp.asarray(toks, jnp.int32), jnp.asarray(xa), DIMS_J))
    if name == "alignment_forward":
        sel, _ = JA._alignment_head_onehot(DIMS_J, [(1, 0), (1, 1), (0, 1)])
        qk, p = JW.alignment_forward(jp, jnp.asarray(toks, jnp.int32),
                                     jnp.asarray(xa), jnp.asarray(sel),
                                     DIMS_J)
        return np.asarray(qk), np.asarray(p)
    return np.asarray(JG.detect_language_batched(
        jp, jnp.asarray(xa), DIMS_J, SP.sot, LANG0, 2))


PASSES = ("decoder_forward", "alignment_forward", "detect_language_batched")


@pytest.mark.parametrize("name", PASSES)
def test_teacher_forced_pass_takes_the_vocab_product(model, name,
                                                     monkeypatch):
    """Without a gradient (grad mode on, nothing requiring grad: how the
    engine calls them) each pass runs one vocab_product and no
    vocab_logits, and gives vocab_logits's bits (the pass run again with
    the product forced through vocab_logits)."""
    jp, tp, xa, toks = model
    calls = _counting(monkeypatch)
    got = _run(name, tp, xa, toks)
    assert calls == {"product": 1, "logits": 0}
    with monkeypatch.context() as m:
        m.setattr(TW, "final_logits", TW.vocab_logits)
        want = _run(name, tp, xa, toks)
    assert calls["logits"] == 1
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", PASSES)
def test_teacher_forced_pass_matches_jax(model, name):
    """decoder_forward within atol 1e-4 (test_torch_whisper.py's limit);
    alignment_forward's sel_qk within 2e-4 and token_probs within 1e-5
    (test_torch_word_align.py's f32 limits); the language probabilities
    within 1e-5 (test_torch_generate.py's)."""
    jp, tp, xa, toks = model
    got = _run(name, tp, xa, toks)
    want = _jax(name, jp, xa, toks)
    if name == "alignment_forward":
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=2e-4)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 if name == "decoder_forward"
                                   else 1e-5)


def test_bf16_decoder_forward_keeps_vocab_logits_bits(model, monkeypatch):
    """The card's dtype (bf16 activations and embedding): the same bits as
    the product through vocab_logits."""
    _, tp, xa, toks = model
    tb = {k: v for k, v in tp.items()}
    tb["decoder"] = dict(tp["decoder"])
    tb["decoder"]["tok_emb"] = tp["decoder"]["tok_emb"].bfloat16()
    tb["decoder"]["ln"] = {k: v.bfloat16()
                           for k, v in tp["decoder"]["ln"].items()}
    x = torch.from_numpy(
        np.random.default_rng(33).standard_normal((3, 7, 128)).astype(
            np.float32)).bfloat16()
    calls = _counting(monkeypatch)
    got = TW.final_logits(tb["decoder"], x)
    assert calls == {"product": 1, "logits": 0}
    assert got.dtype == torch.float32
    assert torch.equal(got, TW.vocab_logits(tb["decoder"], x))


def _leaf_tree(tp, grad):
    """A copy of the port's params with every float leaf a fresh leaf
    tensor (requiring grad where ``grad``)."""
    if isinstance(tp, dict):
        return {k: _leaf_tree(v, grad) for k, v in tp.items()}
    t = tp.detach().clone()
    if grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def test_training_loss_differentiates_through_vocab_logits(model,
                                                           monkeypatch):
    """A training case at 2 + 2 layers: the cross-entropy loss over params
    that require grad runs the product through vocab_logits (never the
    product without a gradient, which would raise), and its backward gives
    the tied embedding a finite, non-zero gradient; the same loss under
    torch.no_grad() takes vocab_product and gives the same value."""
    _, tp, _, toks = model
    rng = np.random.default_rng(34)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 80)).astype(
        np.float32))
    tok = torch.from_numpy(toks[:2])
    tgt = torch.roll(tok, -1, dims=1)
    mask = torch.ones(tok.shape, dtype=torch.float32)
    params = _leaf_tree(tp, grad=True)
    calls = _counting(monkeypatch)
    loss = TT.cross_entropy_loss(params, mel, tok, tgt, mask, DIMS_T)
    assert calls == {"product": 0, "logits": 1}
    loss.backward()
    g = params["decoder"]["tok_emb"].grad
    assert g is not None and bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0
    with torch.no_grad():
        again = TT.cross_entropy_loss(params, mel, tok, tgt, mask, DIMS_T)
    assert calls == {"product": 1, "logits": 1}
    assert torch.equal(again, loss.detach())


def test_cut_over_mirrors_the_c_plan():
    """ops/vocab.py picks the path from M without calling the C plan: its
    TILES_ABOVE is csrc/vocab_gemm.cu's VG_TILES_ABOVE, and the decode
    steps' rows (6 to 64) stay on the passes path."""
    import re
    from pathlib import Path

    from whisper_aries_tpu_torch.ops import vocab as VO

    src = (Path(VO.__file__).parent.parent / "csrc" / "vocab_gemm.cu"
           ).read_text(encoding="utf-8")
    found = re.search(r"constexpr int VG_TILES_ABOVE = (\d+);", src)
    assert found and int(found.group(1)) == VO.TILES_ABOVE == 64
    assert VO.PATHS == ("passes", "tiles")
    assert VO.vocab_product_kernel.launches_by_path.keys() == set(VO.PATHS)


def test_variants_tool_finds_its_edits():
    """chip_vocab_variants.py makes each variant of the vocab kernel by one
    text edit of csrc/vocab_gemm.cu: every edit still finds its place, and
    every variant differs from the source."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_vocab_variants", root / "chip_vocab_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "whisper_aries_tpu_torch" / "csrc" / "vocab_gemm.cu"
           ).read_text(encoding="utf-8")
    made = tool.variants(src)
    assert set(made) == {"base", "nostore", "nomma", "nomma_nostore"}
    assert made["base"] == src
    assert all(made[k] != src for k in made if k != "base")

"""The training counterpart of the encoder-attention kernel
(csrc/encoder_attn_train.cu): its plain versions on the CPU against
``jax.vjp`` of the JAX package's ``_attention_xla`` (the path the JAX
train step takes: JAX cannot differentiate ``_flash_attention_pallas``),
and, marked ``cuda``, the kernels against the plain versions on a card.

All f32. On the CPU the two frameworks sum the products in other orders:
outputs and gradients agree to 2e-5 of the largest value (f32 sums of
T terms)."""

import numpy as np
import pytest
import torch

TOL = 2e-5


def _rel(a, b):
    """max |a - b| / max |b|; where b is all zeros (one key: dq and dk are
    exactly 0), max |a - b| itself."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err, big = float(np.abs(a - b).max()), float(np.abs(b).max())
    return err / big if big else err


def _inputs(B, H, T, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, 64)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, g


@pytest.mark.parametrize("T", [48, 37, 130])
def test_plain_forward_and_backward_match_jax(T):
    """T 48 (the JAX train test's n_audio_ctx) and T that no tile divides:
    the plain forward, its log-sum-exp and the autograd backward against
    ``jax.vjp`` of ``_attention_xla``."""
    import jax
    import jax.numpy as jnp
    from whisper_aries_tpu.models import whisper as JW

    from whisper_aries_tpu_torch.models import whisper as W

    q, k, v, g = _inputs(2, 2, T, seed=T)
    want, vjp = jax.vjp(JW._attention_xla, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    dq_w, dk_w, dv_w = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    got = W.attention_plain(tq, tk, tv)
    assert _rel(got, want) < TOL
    for a, b in zip(W.attention_backward_plain(tq, tk, tv, tg),
                    (dq_w, dk_w, dv_w)):
        assert _rel(a, b) < TOL
    # the log-sum-exp the kernel keeps, against the JAX logits'
    logits = np.einsum("bhqd,bhkd->bhqk", q * np.float32(0.125), k)
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    assert _rel(W.attention_lse_plain(tq, tk), lse) < TOL


def test_encoder_attention_on_cpu_is_differentiable_plain():
    """On CPU tensors ``encoder_attention`` is the plain version, so the
    encoder's autograd is attention_plain's."""
    from whisper_aries_tpu_torch.models import whisper as W

    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 2, 20, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    W.encoder_attention(*leaves).backward(g)
    for a, b in zip([t.grad for t in leaves],
                    W.attention_backward_plain(q, k, v, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_kernels_refuse_cpu_operands():
    from whisper_aries_tpu_torch.models import whisper as W

    x = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        W.encoder_attn_train_fwd_kernel(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        W.encoder_attn_train_bwd_kernel(x, x, x, x, torch.zeros((1, 2, 8)),
                                        x)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [3, 20])
@pytest.mark.parametrize("T", [48, 37, 130, 1500, 1, 63, 64, 65, 127, 128,
                               129, 95, 96, 97])
def test_train_kernels_match_plain_on_the_card(dev, T, H):
    """Forward (out, lse) and backward (dq, dk, dv) against the plain
    versions, within 2e-5 of the largest value; with one key past T scored
    as a zero key the plain forward moves more than that. Two runs of the
    backward give the same bits (no atomics). T at the tiles' edges (one
    key; a 64-row tile less one, one, and one more, and two of them; the
    forward's 96-row block less one, one, one more), and B H 6 and 40 (the
    train path's heads)."""
    from whisper_aries_tpu_torch.models import whisper as W

    q, k, v, g = (torch.from_numpy(a).to(dev)
                  for a in _inputs(2, H, T, seed=T + 1))
    out, lse = W.encoder_attn_train_fwd_kernel(q, k, v)
    assert _rel(out.cpu(), W.attention_plain(q, k, v).cpu()) < TOL
    assert _rel(lse.cpu(), W.attention_lse_plain(q, k).cpu()) < TOL
    z = torch.zeros_like(k[:, :, :1])
    wrong = W.attention_plain(q, torch.cat([k, z], 2), torch.cat([v, z], 2))
    assert _rel(wrong.cpu(), W.attention_plain(q, k, v).cpu()) > TOL
    grads = W.encoder_attn_train_bwd_kernel(q, k, v, out, lse, g)
    for a, b in zip(grads, W.attention_backward_plain(q, k, v, g)):
        assert _rel(a.cpu(), b.cpu()) < TOL
    again = W.encoder_attn_train_bwd_kernel(q, k, v, out, lse, g)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_encoder_attention_routes_f32_to_train_kernels(dev):
    """f32 CUDA operands go through the training kernels (one forward and
    one backward launch), bf16 ones that need a gradient raise."""
    from whisper_aries_tpu_torch.models import whisper as W

    q, k, v, g = (torch.from_numpy(a).to(dev) for a in _inputs(1, 2, 40, 5))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = (W.encoder_attn_train_fwd_kernel.launches,
              W.encoder_attn_train_bwd_kernel.launches)
    W.encoder_attention(*leaves).backward(g)
    assert W.encoder_attn_train_fwd_kernel.launches == f0 + 1
    assert W.encoder_attn_train_bwd_kernel.launches == b0 + 1
    for a, b in zip([t.grad for t in leaves],
                    W.attention_backward_plain(q, k, v, g)):
        assert _rel(a.cpu(), b.cpu()) < TOL
    bf = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
    with pytest.raises(RuntimeError, match="no backward"):
        W.encoder_attention(*bf)

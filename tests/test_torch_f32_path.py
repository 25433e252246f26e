"""compute_type "f32" on the card, the parts that the CPU can hold: the
vocab product's dispatch by dtype (the kernel for bf16 operands, the
counted "f32" library path for f32 ones, mixed dtypes refused), the byte
model at 4-byte activations, the engine's activation dtype for each
compute_type, and the TF32 hold that the f32 engine's entry points take.
The kernels of the f32 path are held on the card (test_torch_cuda.py,
chip_smoke.py's slice_f32 phase); the decoder-layer stack at f32 against
the JAX megakernel is in test_torch_decode_layers.py, the decodes in
test_torch_generate.py and test_torch_beam.py."""

import threading

import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from whisper_aries_tpu_torch.models.whisper import PRESETS
from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops import vocab as VO
from whisper_aries_tpu_torch.parallel import mesh as TM
from whisper_aries_tpu_torch.pipeline.engine import activation_dtype
from whisper_aries_tpu_torch.utils.device import no_tf32

BF, F32 = torch.bfloat16, torch.float32


class _Card:
    """A stand-in operand that reports itself on a card: vocab_product
    reads ``is_cuda`` and the dtypes before it calls a path."""

    def __init__(self, t):
        self.t, self.is_cuda, self.dtype = t, True, t.dtype


@pytest.fixture
def routes(monkeypatch):
    """vocab_product's card paths replaced by recorders."""
    took = []
    monkeypatch.setattr(VO, "vocab_product_kernel",
                        lambda x, e: took.append("kernel") or "kernel")
    monkeypatch.setattr(VO, "vocab_product_f32",
                        lambda x, e: took.append("f32") or "f32")
    return took


@pytest.mark.parametrize("dtype,path", [(BF, "kernel"), (F32, "f32")])
def test_vocab_product_dispatches_by_dtype(routes, dtype, path):
    x, emb = torch.zeros((6, 64), dtype=dtype), torch.zeros((9, 64),
                                                            dtype=dtype)
    assert VO.vocab_product(_Card(x), _Card(emb)) == path
    assert routes == [path]


@pytest.mark.parametrize("xd,ed", [(F32, BF), (BF, F32),
                                   (torch.float16, torch.float16)])
def test_vocab_product_refuses_mixed_dtypes(routes, xd, ed):
    x, emb = torch.zeros((6, 64), dtype=xd), torch.zeros((9, 64), dtype=ed)
    with pytest.raises(ValueError, match="must both be bf16"):
        VO.vocab_product(_Card(x), _Card(emb))
    assert routes == []


def test_vocab_product_cpu_operands_take_the_plain_version(routes):
    g = torch.Generator().manual_seed(0)
    x, emb = torch.randn((6, 64), generator=g), torch.randn((9, 64),
                                                           generator=g)
    torch.testing.assert_close(VO.vocab_product(x, emb),
                               VO.vocab_product_plain(x, emb), rtol=0,
                               atol=0)
    assert routes == []


def test_f32_path_is_counted(monkeypatch):
    """The "f32" path (its operand check lifted: the CPU has no card)
    computes the plain version's product, counts one launch, reports it in
    ``launches_by_path`` beside the kernel's paths, counts into a graph
    capture's record instead, and holds TF32 off during the product."""
    monkeypatch.setattr(cb, "require", lambda *a, **k: None)
    monkeypatch.setattr(VO.vocab_product_f32, "launches", 0)
    seen = []
    real = torch.matmul

    def matmul(a, b):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(a, b)

    g = torch.Generator().manual_seed(1)
    x, emb = torch.randn((5, 64), generator=g), torch.randn((11, 64),
                                                           generator=g)
    want = VO.vocab_product_plain(x, emb)
    monkeypatch.setattr(torch, "matmul", matmul)
    got = VO.vocab_product_f32(x, emb)
    torch.testing.assert_close(got, want)
    assert got.shape == (5, 11) and got.dtype == F32
    assert seen == [(False, False)]
    assert VO.vocab_product_f32.launches == 1
    by_path = VO.launches_by_path()
    assert set(by_path) == {"passes", "tiles", "f32"}
    assert by_path["f32"] == 1
    with cb.recording() as rec:
        VO.vocab_product_f32(x, emb)
    assert rec == {(VO.vocab_product_f32, None): 1}
    assert VO.vocab_product_f32.launches == 1


def test_vocab_kernel_still_refuses_f32():
    """The kernel takes bf16 only: f32 operands never reach it."""
    x, emb = torch.zeros((6, 64)), torch.zeros((9, 64))
    with pytest.raises(ValueError):
        VO.vocab_product_kernel(x, emb)


def test_window_bytes_at_f32_activations():
    """At 4-byte activations the encoder's and a non-int8 cache's terms
    double; the int8 cross K/V and int8 self cache's int8 values and
    scales do not (the prefill's own cache in the activation type does)."""
    dims = PRESETS["large-v3"]
    L, d, H, Ta = dims.n_text_layer, dims.n_text_state, dims.n_text_head, \
        dims.n_audio_ctx
    enc = TM.ENC_TENSORS * Ta * dims.n_audio_state
    elems = 2 * L * d * 227
    rows = 5
    for kv_int8 in (False, True):
        # a non-int8 self cache: the cache, the encoder and (bf16 cross
        # K/V) the cross term double
        b2 = TM.window_bytes(dims, rows, 227, kv_int8, False, act_bytes=2)
        b4 = TM.window_bytes(dims, rows, 227, kv_int8, False, act_bytes=4)
        cross = 0 if kv_int8 else 2 * L * d * Ta * 2
        assert b4 - b2 == rows * elems * 2 + enc * 2 + cross
        # an int8 self cache: only its activation-type prefill copy
        c2 = TM.window_bytes(dims, rows, 227, kv_int8, True, act_bytes=2)
        c4 = TM.window_bytes(dims, rows, 227, kv_int8, True, act_bytes=4)
        assert c4 - c2 == rows * elems * 2 + enc * 2 + cross
    assert TM.window_bytes(dims, rows, 227) == TM.window_bytes(
        dims, rows, 227, act_bytes=2)


def test_auto_windows_size_f32_batches():
    """The batch at f32 is sized by the wider windows: fewer of them in
    the same free memory, never 0."""
    free = 40 * 2 ** 30
    n2 = TM.auto_windows_per_device(free_bytes=free)
    n4 = TM.auto_windows_per_device(free_bytes=free, act_bytes=4)
    per4 = TM.window_bytes(PRESETS["large-v3"], rows=TM.LADDER_ROWS,
                           cache_len=TM.PROMPT_LEN + 224, act_bytes=4)
    assert n4 == free // per4 and 1 <= n4 < n2
    assert TM.auto_windows_per_device(free_bytes=1, act_bytes=4) == 1


@pytest.mark.parametrize("compute_type,on_cuda,want", [
    ("f32", True, F32), ("float32", True, F32), ("bf16", True, BF),
    ("int8", True, BF), ("f32", False, F32), ("bf16", False, F32),
    ("int8", False, F32)])
def test_activation_dtype(compute_type, on_cuda, want):
    """The JAX engine's rule: f32 for "f32" whatever the backend; the card
    runs bf16 activations otherwise, the CPU f32."""
    assert activation_dtype(compute_type, on_cuda) is want


def test_no_tf32_holds_across_threads():
    """Overlapping holds in two threads keep TF32 off until the last one
    leaves, then restore what the first one found."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        entered, release = threading.Event(), threading.Event()

        def other():
            with no_tf32():
                entered.set()
                release.wait(10)

        t = threading.Thread(target=other)
        with no_tf32():
            t.start()
            entered.wait(10)
        # this thread left first: the other still holds
        assert not any(f.allow_tf32 for f in flags)
        release.set()
        t.join(10)
        assert all(f.allow_tf32 for f in flags)
        with no_tf32():
            with no_tf32():
                pass
            assert not any(f.allow_tf32 for f in flags)
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b

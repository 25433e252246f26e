"""The diarizer's trainers in the port (training/diarize_train.py) against
the JAX package's: ``train_vad`` and ``train_embedding`` for 3 steps from
JAX's init (carried into the port through ``params_from_jax``), the PIT
loss and its gradients on one augmented batch given to both, the port's
augmentation keeping labels on their audio, the verified save, and
``main``.

Tolerances (f32; the frameworks sum convolutions and products in other
orders): losses within 1e-5 relative; gradients within 1e-5 of each
leaf's largest value. Params after n steps: within 1e-5 of each leaf's
largest value plus 1% of the learning rate, but for at most 1e-4 of all
elements, and every element within 2 n lr. Adam divides each gradient
element by its own RMS, so an element whose gradient is rounding noise
steps by a share of lr that differs between the frameworks (measured
after 3 steps: 99.9% of elements within 1e-4 lr; 1 VAD element at 2% of
lr; 3 embedding elements past 1%, among them ``att.b``, a bias added to
every score of a softmax over time whose gradient is zero but for
rounding, 1.7 lr apart)."""

import functools
import logging

import numpy as np
import pytest
import torch

from whisper_aries_tpu_torch.training import diarize_train as TT

RTOL = 1e-5


def _flat(tree):
    from whisper_aries_tpu_torch.utils.params_io import flatten_params

    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _close(got, want, atol=0.0, floor=0.0, stragglers=None):
    """Each leaf within RTOL of its largest value (at least ``floor``) plus
    ``atol``; with ``stragglers`` = (share, limit), up to that share of
    all elements may exceed it, each within ``limit``."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    over, total = 0, 0
    for k in w:
        scale = max(float(np.abs(w[k]).max()), floor)
        err = np.abs(g[k].astype(np.float64) - w[k])
        bad = err > RTOL * scale + atol
        total += err.size
        if stragglers is None:
            assert not bad.any(), (k, float(err.max()), scale)
        else:
            over += int(bad.sum())
            assert float(err.max()) <= stragglers[1], (k, float(err.max()))
    if stragglers is not None:
        assert over <= stragglers[0] * total, (over, total)


def _jax_losses(caplog, what):
    """The losses the JAX trainer logged at every step (log_every=1), at
    full precision (the log record's arguments)."""
    return [r.args[1] for r in caplog.records
            if r.name == "whisper_aries_tpu.training.diarize_train"
            and r.msg.startswith(f"{what} step")]


def test_train_vad_matches_jax(monkeypatch, caplog):
    import jax
    from whisper_aries_tpu.models.vad_net import init_vad as jinit
    from whisper_aries_tpu.training import diarize_train as JT

    from whisper_aries_tpu_torch.models.whisper import params_from_jax

    init = jax.tree.map(np.asarray, jinit())
    monkeypatch.setattr(TT, "init_vad", lambda dims: params_from_jax(init))
    kw = dict(steps=3, batch=4, lr=1e-3, seed=0, n_train=4, n_val=1,
              log_every=1)
    caplog.set_level(logging.INFO)
    jp, jm = JT.train_vad(**kw)
    want_losses = _jax_losses(caplog, "vad")
    tp, tm = TT.train_vad(**kw, device="cpu")
    assert len(want_losses) == len(tm["losses"]) == 3
    np.testing.assert_allclose(tm["losses"], want_losses, rtol=RTOL)
    _close(tp, jax.tree.map(np.asarray, jp), atol=1e-2 * kw["lr"],
           stragglers=(1e-4, 2 * 3 * kw["lr"]))
    assert set(jm) <= set(tm)
    for k in ("val_acc", "val_acc_energy_baseline"):
        assert abs(tm[k] - jm[k]) <= 2e-3  # one frame of 310 may flip


def test_train_embedding_matches_jax(monkeypatch, caplog):
    import jax
    from whisper_aries_tpu.models.diarize_nets import init_embedding as jinit
    from whisper_aries_tpu.training import diarize_train as JT

    from whisper_aries_tpu_torch.models.whisper import params_from_jax

    init = jax.tree.map(np.asarray, jinit())
    monkeypatch.setattr(TT, "init_embedding",
                        lambda dims: params_from_jax(init))
    # a smaller validation draw in both packages (its 60 default
    # utterances take seconds to synthesise)
    monkeypatch.setattr(JT, "_emb_val_metrics", functools.partial(
        JT._emb_val_metrics, n_spk=3, n_utt=2))
    monkeypatch.setattr(TT, "_emb_val_metrics", functools.partial(
        TT._emb_val_metrics, n_spk=3, n_utt=2))
    kw = dict(steps=3, n_spk=3, n_utt=2, lr=3e-4, seed=2, log_every=1,
              n_batches=2)
    caplog.set_level(logging.INFO)
    jp, jm = JT.train_embedding(**kw)
    want_losses = _jax_losses(caplog, "emb")
    tp, tm = TT.train_embedding(**kw, device="cpu")
    np.testing.assert_allclose(tm["losses"], want_losses, rtol=RTOL)
    _close(tp, jax.tree.map(np.asarray, jp), atol=1e-2 * kw["lr"],
           stragglers=(1e-4, 2 * 3 * kw["lr"]))
    for k in ("same_cos", "diff_cos", "margin"):
        assert abs(tm[k] - jm[k]) <= 1e-4


def _seg_batch(seed=3, B=2):
    X, Y = TT._dataset_seg(np.random.default_rng(seed), B)
    gen = torch.Generator().manual_seed(seed)
    audio, act = TT.seg_augment(torch.from_numpy(X), torch.from_numpy(Y),
                                gen)
    return audio, act


def test_pit_loss_and_gradients_match_jax():
    """One augmented batch to both: the JAX side is the JAX trainer's
    pit_loss without its jax.random augmentation (segmentation_forward,
    log_mel_spectrogram, _POWERSET_LOOKUP, _PERMS)."""
    import jax
    import jax.numpy as jnp
    from whisper_aries_tpu.audio.mel import log_mel_spectrogram
    from whisper_aries_tpu.models.diarize_nets import (
        SegDims,
        init_segmentation,
        segmentation_forward,
    )
    from whisper_aries_tpu.training import diarize_train as JT

    from whisper_aries_tpu_torch.models.whisper import params_from_jax
    from whisper_aries_tpu_torch.utils.params_io import flatten_params

    dims = SegDims()
    jparams = jax.tree.map(np.asarray, init_segmentation(dims))
    audio, act = _seg_batch()
    lookup, perms = jnp.asarray(JT._POWERSET_LOOKUP), jnp.asarray(JT._PERMS)

    def jloss(p, audio, act):
        logp = segmentation_forward(p, log_mel_spectrogram(audio), dims)
        a = act.astype(jnp.int32)

        def perm_ce(perm):
            ap = a[:, :, perm]
            cls = lookup[ap[..., 0], ap[..., 1], ap[..., 2]]
            return -jnp.take_along_axis(logp, cls[..., None],
                                        axis=-1)[..., 0].mean(axis=1)

        return jnp.min(jax.vmap(perm_ce)(perms), axis=0).mean()

    want, jgrads = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(audio.numpy()),
        jnp.asarray(act.numpy()))
    params = params_from_jax(jparams)
    flat = flatten_params(params)
    for t in flat.values():
        t.requires_grad_(True)
    got = TT.pit_loss(params, audio, act)
    grads = torch.autograd.grad(got, list(flat.values()))
    assert abs(float(got.detach()) - float(want)) <= RTOL * abs(float(want))
    _close(dict(zip(flat, grads)), jax.tree.map(np.asarray, jgrads),
           floor=1e-3)


def test_seg_augment_keeps_labels_on_their_audio():
    """With no added noise, a label frame is active exactly where its 320
    samples are nonzero, after the shift, in every example; the gains and
    shifts follow the generator's seed."""
    B, F = 4, 50
    rng = np.random.default_rng(0)
    act = (rng.uniform(size=(B, F, 3)) < 0.3).astype(np.float32)
    audio = np.repeat(act[:, :, 0], TT.HOP, axis=1) * rng.uniform(
        0.5, 1.0, size=(B, F * TT.HOP)).astype(np.float32)
    a, y = TT.seg_augment(torch.from_numpy(audio), torch.from_numpy(act),
                          torch.Generator().manual_seed(1), noise=(0.0, 0.0))
    frames = a.reshape(B, F, TT.HOP).abs().amax(-1) > 0
    assert torch.equal(frames, y[:, :, 0] > 0)
    assert not torch.equal(y, torch.from_numpy(act))  # something shifted
    again = TT.seg_augment(torch.from_numpy(audio), torch.from_numpy(act),
                           torch.Generator().manual_seed(1),
                           noise=(0.0, 0.0))
    assert torch.equal(a, again[0]) and torch.equal(y, again[1])


def test_save_verified_round_trip(tmp_path):
    """The verified save reads back bit for bit, in the port's loader and
    the JAX package's."""
    from whisper_aries_tpu.models.vad_net import init_vad as jinit
    from whisper_aries_tpu.utils.params_io import load_params_into as jload

    from whisper_aries_tpu_torch.models.vad_net import init_vad
    from whisper_aries_tpu_torch.utils.params_io import load_params_into

    params = init_vad()
    path = str(tmp_path / "vad.safetensors")
    TT._save_verified(path, params)
    back = load_params_into(init_vad(), path)
    for k, v in _flat(params).items():
        assert _flat(back)[k].tobytes() == v.tobytes()
    jback = jload(jinit(), path)
    for k, v in _flat(params).items():
        assert _flat(jback)[k].tobytes() == v.tobytes()


def test_main_writes_only_under_out(tmp_path, monkeypatch, capsys):
    """main --target vad --steps 2 --out DIR --device cpu: the checkpoint
    and TRAINING.json land in DIR (merged with what was there), nothing
    else is written to the tree's weights."""
    import json

    from whisper_aries_tpu_torch.utils.params_io import default_weights_dir

    monkeypatch.setattr(TT, "train_vad", functools.partial(
        TT.train_vad, n_train=4, n_val=1, batch=4))
    shipped = {p: p.stat().st_mtime_ns
               for p in default_weights_dir().iterdir()}
    out = tmp_path / "out"
    out.mkdir()
    (out / "TRAINING.json").write_text(json.dumps({"embedding": {"x": 1}}))
    assert TT.main(["--target", "vad", "--steps", "2", "--out", str(out),
                    "--device", "cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["TRAINING.json",
                                                    "vad.safetensors"]
    rec = json.loads((out / "TRAINING.json").read_text())
    assert rec["embedding"] == {"x": 1} and "val_acc" in rec["vad"]
    assert "losses" not in rec["vad"]
    assert {p: p.stat().st_mtime_ns
            for p in default_weights_dir().iterdir()} == shipped
    assert TT.DEFAULT_OUT.name == "trained_weights"
    assert "vad" in json.loads(capsys.readouterr().out)


def test_trainers_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (TT.train_vad, TT.train_segmentation, TT.train_embedding):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(steps=1)

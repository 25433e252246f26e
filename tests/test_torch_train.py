"""Whisper fine-tuning in the port (pipeline/train.py, pipeline/
checkpoint.py) against the JAX package's, on the JAX train test's tiny
dims (tests/test_train.py): the loss and every leaf's gradient, one and
three AdamW steps over a mesh of 4 CPU replicas against JAX's
``make_train_step`` on its 8-device CPU mesh over the same global batch,
the masking, and the train state on disk.

Tolerances: f32 throughout; the frameworks sum in other orders (and the
replicas' gradients in another grouping), so the loss agrees to 1e-5
relative and each gradient leaf to 1e-5 of its largest value (1e-8
absolute for leaves that are all but zero). The params after a step agree
to 1e-5 of each leaf's largest value plus 1% of the learning rate: Adam
divides each gradient element by its own RMS, so an element whose
gradient is rounding noise (the decoder's K projection has such elements:
~0.6% of lr apart, measured) steps by a share of lr that differs between
the frameworks."""

import numpy as np
import pytest
import torch

RTOL = 1e-5


def _dims(W):
    return W.WhisperDims(
        n_mels=80, n_audio_ctx=48, n_audio_state=64, n_audio_head=2,
        n_audio_layer=2, n_vocab=128, n_text_ctx=24, n_text_state=64,
        n_text_head=2, n_text_layer=2)


@pytest.fixture
def setup():
    import jax
    from whisper_aries_tpu.models import whisper as JW

    from whisper_aries_tpu_torch.models import whisper as W

    jparams = jax.tree.map(np.asarray, JW.init_params(_dims(JW)))
    rng = np.random.default_rng(0)
    B = 16
    batch = {
        "mel": rng.standard_normal((B, 80, 96)).astype(np.float32),
        "tokens_in": rng.integers(0, 128, (B, 8)).astype(np.int32),
        "tokens_tgt": rng.integers(0, 128, (B, 8)).astype(np.int32),
        "mask": np.ones((B, 8), np.float32),
    }
    batch["mask"][3, 5:] = 0.0
    batch["mask"][12, 2:] = 0.0
    return _dims(JW), _dims(W), jparams, batch


def _flat(tree):
    from whisper_aries_tpu_torch.utils.params_io import flatten_params

    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _close_trees(got, want, rtol=RTOL, floor=0.0, atol=0.0):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        scale = max(float(np.abs(w[k]).max()), floor)
        err = float(np.abs(g[k].astype(np.float64) - w[k]).max())
        assert err <= rtol * scale + atol, (k, err, scale)


def test_loss_and_gradients_match_jax(setup):
    import jax
    import jax.numpy as jnp
    from whisper_aries_tpu.pipeline import train as JT

    from whisper_aries_tpu_torch.models.whisper import params_from_jax
    from whisper_aries_tpu_torch.pipeline.train import cross_entropy_loss
    from whisper_aries_tpu_torch.utils.params_io import flatten_params

    jd, td, jparams, batch = setup
    args = [jnp.asarray(batch[k]) for k in ("mel", "tokens_in", "tokens_tgt",
                                            "mask")]
    jloss, jgrads = jax.value_and_grad(JT.cross_entropy_loss)(
        jax.tree.map(jnp.asarray, jparams), *args, jd)
    params = params_from_jax(jparams)
    leaves = list(flatten_params(params).values())
    for t in leaves:
        t.requires_grad_(True)
    loss = cross_entropy_loss(params, *(torch.from_numpy(batch[k]) for k in
                                        ("mel", "tokens_in", "tokens_tgt",
                                         "mask")), td)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= RTOL * abs(
        float(jloss))
    got = dict(zip(flatten_params(params), grads))
    _close_trees(got, jax.tree.map(np.asarray, jgrads), floor=1e-3)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_on_4_replicas_match_jax_on_8_devices(setup, steps):
    """The port's step over a mesh of 4 CPU replicas and JAX's on its
    8-device CPU mesh, from the same params and batch: the loss after each
    step and the params after the last (tolerances above); the four
    replicas' inputs are the four quarters of the global batch."""
    import jax
    from whisper_aries_tpu.parallel.mesh import make_mesh as jmesh
    from whisper_aries_tpu.parallel.mesh import replicate_params as jrep
    from whisper_aries_tpu.pipeline.train import make_train_step as jstep

    from whisper_aries_tpu_torch.models.whisper import params_from_jax
    from whisper_aries_tpu_torch.parallel.mesh import make_mesh
    from whisper_aries_tpu_torch.pipeline.train import make_train_step

    jd, td, jparams, batch = setup
    mesh = jmesh()
    assert len(mesh.devices.ravel()) == 8
    jinit, jtrain, jshard = jstep(jd, mesh, learning_rate=1e-3)
    jp = jrep(jax.tree.map(jax.numpy.asarray, jparams), mesh)
    jo = jinit(jp)
    jb = jshard(batch)
    tmesh = make_mesh(devices=["cpu"] * 4)
    init, train, shard = make_train_step(td, tmesh, learning_rate=1e-3)
    params = params_from_jax(jparams)
    opt = init(params)
    shards = shard(batch)
    assert [len(s["mask"]) for s in shards] == [4, 4, 4, 4]
    for _ in range(steps):
        jp, jo, jl = jtrain(jp, jo, jb)
        params, opt, loss = train(params, opt, shards)
        assert abs(float(loss) - float(jl)) <= RTOL * abs(float(jl))
    _close_trees(params, jax.tree.map(np.asarray, jp), atol=1e-2 * 1e-3)
    assert opt["count"] == steps


def test_adamw_state_carried_from_optax(setup):
    """An optax adamw state turns into the port's: a step from it equals
    optax's update of the same params and gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    from whisper_aries_tpu_torch.pipeline.train import (
        adamw_update,
        opt_state_from_optax,
    )

    rng = np.random.default_rng(4)
    p = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
         "b": [rng.standard_normal(7).astype(np.float32)]}
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), p)
    tx = optax.adamw(1e-2, weight_decay=0.01)
    st = tx.init(jax.tree.map(jnp.asarray, p))
    for _ in range(2):  # a state with count 2 and nonzero moments
        u, st = tx.update(g, st, p)
        p = jax.tree.map(np.asarray, optax.apply_updates(p, u))
    port = opt_state_from_optax(jax.tree.map(np.asarray, st))
    assert port["count"] == 2
    u, st = tx.update(g, st, p)
    want = jax.tree.map(np.asarray, optax.apply_updates(p, u))
    tp = jax.tree.map(lambda x: torch.tensor(x), p)
    tg = {k: torch.tensor(v) for k, v in _flat(g).items()}
    adamw_update(tp, tg, port, 1e-2, 0.01)
    _close_trees(tp, want, rtol=1e-6)
    assert port["count"] == 3


def test_loss_masking(setup):
    """tests/test_train.py:49 in the port: zeroing half the mask changes
    the loss, which stays finite; both losses equal JAX's."""
    import jax.numpy as jnp
    from whisper_aries_tpu.pipeline.train import cross_entropy_loss as jloss

    from whisper_aries_tpu_torch.models.whisper import params_from_jax
    from whisper_aries_tpu_torch.pipeline.train import cross_entropy_loss

    jd, td, jparams, batch = setup
    params = params_from_jax(jparams)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    full = float(cross_entropy_loss(params, t["mel"], t["tokens_in"],
                                    t["tokens_tgt"], t["mask"], td))
    m2 = batch["mask"].copy()
    m2[:, 4:] = 0.0
    half = float(cross_entropy_loss(params, t["mel"], t["tokens_in"],
                                    t["tokens_tgt"], torch.from_numpy(m2),
                                    td))
    assert full != half and np.isfinite(half)
    jp = {k: v for k, v in jparams.items()}
    for mask, got in ((batch["mask"], full), (m2, half)):
        want = float(jloss(jp, jnp.asarray(batch["mel"]),
                           jnp.asarray(batch["tokens_in"]),
                           jnp.asarray(batch["tokens_tgt"]),
                           jnp.asarray(mask), jd))
        assert abs(got - want) <= RTOL * abs(want)


def test_train_state_round_trip(tmp_path, setup):
    """Params and the optimizer state come back bit for bit; no step
    restores the newest; an empty directory raises FileNotFoundError."""
    from whisper_aries_tpu_torch.models.whisper import params_from_jax
    from whisper_aries_tpu_torch.parallel.mesh import make_mesh
    from whisper_aries_tpu_torch.pipeline.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from whisper_aries_tpu_torch.pipeline.train import make_train_step

    jd, td, jparams, batch = setup
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path))
    init, train, _ = make_train_step(td, make_mesh(devices=["cpu"]),
                                     learning_rate=1e-3)
    params = params_from_jax(jparams)
    opt = init(params)
    params, opt, _ = train(params, opt, batch)
    path = save_train_state(str(tmp_path), 42, params, opt)
    assert path.endswith("step_00000042")
    save_train_state(str(tmp_path), 7, params)
    step, state = restore_train_state(str(tmp_path))
    assert step == 42
    for a, b in ((state["params"], params), (state["opt_state"]["mu"],
                                             opt["mu"]),
                 (state["opt_state"]["nu"], opt["nu"])):
        ga, gb = _flat(a), _flat(b)
        assert set(ga) == set(gb)
        for k in gb:
            assert ga[k].dtype == gb[k].dtype
            assert ga[k].tobytes() == gb[k].tobytes(), k
    assert state["opt_state"]["count"] == opt["count"] == 1
    step, state = restore_train_state(str(tmp_path), step=7)
    assert step == 7 and "opt_state" not in state
    # a tree with lists (the diarizer's nets) keeps its lists
    tree = {"stem": [{"w": torch.ones(2)}, {"w": torch.zeros(3)}]}
    save_train_state(str(tmp_path / "v"), 1, tree)
    back = restore_train_state(str(tmp_path / "v"))[1]["params"]
    assert isinstance(back["stem"], list) and len(back["stem"]) == 2


def test_export_loads_in_the_jax_package(tmp_path, setup):
    """The port's export, read by the JAX package's loaders, equals the
    params key for key (the JAX export's keys: tests/test_train.py)."""
    from safetensors.numpy import load_file
    from whisper_aries_tpu.pipeline.checkpoint import _flatten
    from whisper_aries_tpu.utils.params_io import load_params_into

    from whisper_aries_tpu_torch.models.whisper import params_from_jax
    from whisper_aries_tpu_torch.pipeline.checkpoint import (
        export_params_safetensors,
    )

    jd, td, jparams, _ = setup
    p = str(tmp_path / "model.safetensors")
    export_params_safetensors(params_from_jax(jparams), p)
    flat = load_file(p)
    want = _flatten(jparams)
    assert set(flat) == set(want)
    assert "decoder.tok_emb" in flat
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v)
    back = load_params_into(jparams, p)
    for k, v in _flatten(back).items():
        np.testing.assert_array_equal(np.asarray(v), want[k])


def test_train_step_raises_without_a_card(monkeypatch):
    """With no mesh the step runs over every visible card: none visible
    and no CPU mesh given, it raises."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.pipeline.train import make_train_step

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_train_step(_dims(W))

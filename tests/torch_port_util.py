"""Shared helpers of the tests that hold the PyTorch port
(whisper_aries_tpu_torch) against the JAX package: tiny random models made
with numpy from a seed, and converters between the two packages' cache
layouts. Not a test module itself."""

import numpy as np

NEG = float(np.finfo(np.float32).min)


def random_jax_tree(dims, seed, weight_std=0.05):
    """A JAX-layout Whisper parameter tree (numpy leaves) with every leaf
    random: weights and biases N(0, std), LayerNorm scales 1 + N(0, 0.1),
    the encoder's sinusoidal positions kept."""
    import jax
    from whisper_aries_tpu.models import whisper as JW

    tmpl = jax.tree.map(np.asarray, JW.init_params(dims, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        if keys[:2] == ["encoder", "pos_emb"]:
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if keys[-1] == "scale":
            return (1.0 + 0.1 * noise).astype(np.float32)
        return (weight_std * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tmpl)


def to_jax(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


def to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def self_cache_to_jax(ckv, ksc, n_head):
    """Port self cache (L, R, 2, H, T, dh) [+ scales (L, R, 2, H, T)] ->
    the JAX megakernel's packed (L, R, 2H, dh, T) [+ (L, R, 2HP, T)]."""
    ckv = np.asarray(ckv)
    L, R, _, H, T, dh = ckv.shape
    big = np.ascontiguousarray(
        ckv.transpose(0, 1, 2, 3, 5, 4).reshape(L, R, 2 * H, dh, T))
    if ksc is None:
        return big, None
    HP = ((n_head + 7) // 8) * 8
    sc = np.zeros((L, R, 2 * HP, T), np.float32)
    sc[:, :, :H] = np.asarray(ksc)[:, :, 0]
    sc[:, :, HP:HP + H] = np.asarray(ksc)[:, :, 1]
    return big, sc


def self_cache_from_jax(big, sc, n_head):
    """Inverse of ``self_cache_to_jax``."""
    big = np.asarray(big)
    L, R, H2, dh, T = big.shape
    H = n_head
    ckv = big.reshape(L, R, 2, H, dh, T).transpose(0, 1, 2, 3, 5, 4)
    if sc is None:
        return ckv, None
    HP = ((H + 7) // 8) * 8
    sc = np.asarray(sc)
    return ckv, np.stack([sc[:, :, :H], sc[:, :, HP:HP + H]], axis=2)


class PieceTokenizer:
    """Word-piece test tokenizer whose decode produces real spaces and
    punctuation (tests/test_longform_parity.py's)."""

    PIECES = [
        " hello", " world", " good", " morning", " how", " are", " you",
        " the", " cat", " sat", " on", " mat", "s", "ing", "ed",
        ".", ",", "?", "!", ":", " ", "a", "b", "c",
    ]

    def __init__(self, build_special_tokens):
        self.specials = build_special_tokens(len(self.PIECES), 2)

    def decode(self, ids, skip_special=True):
        return "".join(self.PIECES[i] for i in ids
                       if 0 <= int(i) < len(self.PIECES))

    def encode(self, text):
        ids, i = [], 0
        by_len = sorted(range(len(self.PIECES)),
                        key=lambda k: -len(self.PIECES[k]))
        while i < len(text):
            for k in by_len:
                p = self.PIECES[k]
                if text.startswith(p, i):
                    ids.append(k)
                    i += len(p)
                    break
            else:
                i += 1
        return ids

    def non_speech_tokens(self, encoder):
        return []


def speechy_audio(seconds, seed=5, sr=16_000):
    """A modulated tone with noise (the long-form parity test's signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.25 * np.sin(2 * np.pi * 220 * t)
         * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t))).astype(np.float32)
    return x + 0.02 * rng.standard_normal(len(x)).astype(np.float32)


def jax_native_library():
    """The JAX package's native library, loaded (its loader builds it in
    place with ``make -C native`` when missing). Several test processes
    may build it at once, and a load can meet a half-written file: such a
    failed load is retried for up to a minute before the test fails."""
    import time

    from whisper_aries_tpu.audio import _native as jn

    for _ in range(60):
        if jn.native_available():
            return jn.load_library()
        jn._load_failed = False  # a load that met another build's file
        time.sleep(1.0)
    raise AssertionError("the JAX package's native library did not load")

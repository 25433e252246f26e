"""The decode loop's body on the CPU: the greedy / sampled choice
(ops/decode_choice.py) and the step's vocab product (ops/vocab.py,
models/whisper.py::vocab_logits_step) against the JAX package.

* The port's plain choice against the JAX ``_apply_filters`` +
  ``log_softmax`` + argmax (decoding/generate.py:143, :357) on states
  that reach every branch of the timestamp grammar (first step and its
  initial cap, timestamps on and off, a pair open and closed, the
  monotonic floor, the force rule on and off, regions masked everywhere,
  finished rows), at temperature 0 and above it (both sides fed the same
  draws: the port's counter hash), at the large-v3 vocabulary (51,866) and
  a narrow one. Tolerances: tokens and every integer state identical,
  ``sum_logprob`` within 1e-6 of its own magnitude (the log-softmax sums
  run in another order).
* A torch emulation of the kernel's algorithm (csrc/decode_choice.cu: the
  row cut in 8 slices, per-slice region maxima and first-index argmaxes
  combined, the sums against the combined maxima added over the slices as
  the kernel's lanes add them, the force
  rule and the choice decided from the partials) against the plain choice,
  with the same tolerances; each named mistake of the kernel (a rule left
  out, the force rule inverted, the draw at pos + 1 or at another row, a
  finished row not forced to eot) must fail that hold on these states.
* The plain vocab product against the JAX logits (``jnp.dot(x, emb.T,
  preferred_element_type=f32)``, models/whisper.py:510) within 1e-5 of
  max |logit|, below the "bf16-rounded logits" mistake."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import one_torch_thread  # noqa: F401
from whisper_aries_tpu.decoding import generate as JG
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models.layers import layer_norm as jax_layer_norm
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.decoding.logit_filters import NEG_INF
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import decode_choice as DC
from whisper_aries_tpu_torch.ops import decode_loop as DLP
from whisper_aries_tpu_torch.ops import vocab as VO

ROOT = Path(__file__).resolve().parents[1]
NEG = np.float32(NEG_INF)
LP_TOL = 1e-6
#: the large-v3 vocabulary (51,866) and a narrow one (1,534)
VOCABS = {"wide": build_special_tokens(50257, 100),
          "narrow": build_special_tokens(24, 2)}
BLANK = {"wide": 220, "narrow": 20}
L, POS, SEED = 12, 5, 1234


def _ids(vocab, jax_side=False):
    sp = VOCABS[vocab]
    cls = JG.DecodeSpecialIds if jax_side else TG.DecodeSpecialIds
    return cls(eot=sp.eot, sot=sp.sot, no_speech=sp.no_speech,
               no_timestamps=sp.no_timestamps,
               timestamp_begin=sp.timestamp_begin, blank=BLANK[vocab],
               n_vocab=sp.n_vocab)


def _inputs(vocab, seed=0):
    """Logits, suppress mask and a state of 9 rows, one grammar branch a
    row: 0 fresh text; 1 a pair open (text forbidden, the floor at the
    open timestamp); 2 a pair closed (every timestamp forbidden: a region
    masked everywhere); 3 text after timestamps (the floor one past the
    max); 4 finished; 5 timestamps boosted (the force rule on); 6
    timestamps sunk (off); 7 text sunk below the timestamps' logsumexp at a
    pair open (text masked, force irrelevant); 8 eot the top logit."""
    sp = VOCABS[vocab]
    V, tsb, eot = sp.n_vocab, sp.timestamp_begin, sp.eot
    rng = np.random.default_rng(seed)
    R = 9
    logits = (3 * rng.standard_normal((R, V))).astype(np.float32)
    logits[5, tsb:] += 12
    logits[6, tsb:] -= 20
    logits[7, :tsb] -= 30
    logits[8, eot] = 40
    mask = np.zeros(V, np.float32)
    mask[[sp.sot, sp.no_speech, sp.transcribe]] = NEG
    mask[rng.choice(sp.eot, 5, replace=False)] = NEG
    last = np.array([3, tsb + 5, tsb + 7, 9, 4, 11, 12, tsb + 9, 2])
    penult = np.array([-1, 6, tsb + 2, tsb + 3, 5, -1, 7, 8, -1])
    max_ts = np.array([-1, tsb + 5, tsb + 7, tsb + 3, -1, -1, -1, tsb + 9,
                       -1])
    finished = np.zeros(R, bool)
    finished[4] = True
    tokens = rng.integers(0, eot, (R, L))
    return dict(logits=logits, mask=mask, last=last, penult=penult,
                max_ts=max_ts, finished=finished, tokens=tokens,
                sum_lp=(-rng.random(R) * 5).astype(np.float32))


def _state(inp, present=False):
    R, V = inp["logits"].shape
    new = lambda a: torch.tensor(a)  # a copy: the state changes in place
    return TG.LoopState(
        tokens=new(inp["tokens"]).long(),
        pos=torch.tensor(POS, dtype=torch.int32),
        finished=new(inp["finished"]),
        sum_logprob=new(inp["sum_lp"]),
        last_tok=new(inp["last"]).long(),
        penult_tok=new(inp["penult"]).long(),
        max_ts_tok=new(inp["max_ts"]).long(),
        present=torch.zeros((R, V), dtype=torch.bool) if present else None,
        steps=torch.tensor(3, dtype=torch.int32),
        arrived=torch.zeros((), dtype=torch.int32))


def _plain(inp, vocab, first, with_ts, T, present=False):
    st = _state(inp, present)
    DC.greedy_choice(torch.from_numpy(inp["logits"]), st, _ids(vocab),
                     torch.from_numpy(inp["mask"]), first, with_ts, True, T,
                     SEED)
    return st


def _gumbel(R, V):
    u = DLP.uniform_draw_plain(SEED, torch.tensor(POS), R, V).numpy()
    return -np.log(-np.log(u))


def _jax_want(inp, vocab, first, with_ts, T):
    """tokens and sum_logprob by the JAX package's filters and
    log_softmax; at a temperature argmax(f / T + gumbel), the gumbel of the
    port's draws (JAX's own come from the TPU's bits)."""
    R, V = inp["logits"].shape
    eot = VOCABS[vocab].eot
    f = JG._apply_filters(
        jnp.asarray(inp["logits"]), _ids(vocab, True),
        jnp.asarray(inp["mask"]), jnp.asarray(first),
        jnp.asarray(inp["last"], jnp.int32),
        jnp.asarray(inp["penult"], jnp.int32),
        jnp.asarray(inp["max_ts"], jnp.int32), with_ts)
    lp = np.asarray(jax.nn.log_softmax(f, axis=-1))
    if T > 0:
        tok = np.asarray(jnp.argmax(f / jnp.float32(T)
                                    + jnp.asarray(_gumbel(R, V)), axis=-1))
    else:
        tok = np.asarray(jnp.argmax(f, axis=-1))
    tok = np.where(inp["finished"], eot, tok)
    tok_lp = lp[np.arange(R), tok]
    return tok, inp["sum_lp"] + np.where(inp["finished"], 0.0, tok_lp)


def _lp_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


GRID = [(first, ts, T) for first in (False, True) for ts in (True, False)
        for T in (0.0, 0.7)]


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("first,with_ts,T", GRID)
def test_plain_choice_matches_jax(vocab, first, with_ts, T):
    inp = _inputs(vocab)
    st = _plain(inp, vocab, first, with_ts, T)
    tok, want_lp = _jax_want(inp, vocab, first, with_ts, T)
    np.testing.assert_array_equal(st.tokens[:, POS].numpy(), tok)
    np.testing.assert_array_equal(st.last_tok.numpy(), tok)
    np.testing.assert_array_equal(st.penult_tok.numpy(), inp["last"])
    np.testing.assert_array_equal(
        st.finished.numpy(), inp["finished"] | (tok == VOCABS[vocab].eot))
    tsb = VOCABS[vocab].timestamp_begin
    np.testing.assert_array_equal(
        st.max_ts_tok.numpy(),
        np.where(tok >= tsb, np.maximum(inp["max_ts"], tok), inp["max_ts"]))
    assert _lp_err(st.sum_logprob.numpy(), want_lp) < LP_TOL
    assert int(st.pos) == POS + 1 and int(st.steps) == 4


def test_grammar_states_reach_their_branches():
    """The states of ``_inputs`` do what their rows say at the wide
    vocabulary, temperature 0, timestamps on: row 2 (pair closed) picks
    text, rows 1 and 7 (pair open) a timestamp at or past the floor or
    eot, row 5 is forced to a timestamp, row 6 is not, row 4 (finished)
    takes eot, row 8 ends."""
    sp = VOCABS["wide"]
    st = _plain(_inputs("wide"), "wide", False, True, 0.0)
    tok = st.last_tok.numpy()
    tsb, eot = sp.timestamp_begin, sp.eot
    assert tok[2] < tsb and tok[5] >= tsb and tok[6] < tsb
    assert tok[1] >= tsb + 5 or tok[1] == eot  # text forbidden at an open pair
    assert tok[7] >= tsb + 9 or tok[7] == eot
    assert tok[4] == eot and tok[8] == eot
    # the first step: a timestamp within the initial cap; row 2 (a closed
    # pair) then has every id masked and takes id 0 (argmax's first index)
    first = _plain(_inputs("wide"), "wide", True, True, 0.0).last_tok.numpy()
    live = ~_inputs("wide")["finished"]
    live[2] = False
    assert ((first[live] >= tsb) & (first[live] <= tsb + 50)).all()
    assert first[2] == 0


# ---------------------------------------------------------------------------
# the kernel's algorithm, emulated in torch
# ---------------------------------------------------------------------------

SLICES = 8  # csrc/decode_choice.cu's blocks a row


def _filtered(logits, ids, mask, first, with_ts, suppress_blank, last,
              penult, max_ts, rule_out=None):
    """csrc/decode_choice.cu's ``row_rules`` + ``filtered``, vectorised."""
    R, V = logits.shape
    v = torch.arange(V)[None, :]
    tsb = ids.timestamp_begin
    f = logits + mask[None, :]
    f = torch.where(v == ids.no_timestamps, NEG_INF, f)
    if first and suppress_blank:
        f = torch.where((v == ids.blank) | (v == ids.eot), NEG_INF, f)
    ts = v >= tsb
    if not with_ts:
        return torch.where(ts, NEG_INF, f)
    last_ts, penult_ts = last >= tsb, penult >= tsb
    sup_ts = (last_ts & penult_ts)[:, None]
    sup_text = (last_ts & ~penult_ts)[:, None]
    has_ts = (max_ts >= tsb)[:, None]
    floor = torch.where(last_ts & ~penult_ts, max_ts, max_ts + 1)[:, None]
    if rule_out != "pair":
        f = torch.where(sup_ts & ts, NEG_INF, f)
        f = torch.where(sup_text & (v < ids.eot), NEG_INF, f)
    if rule_out != "monotonic":
        f = torch.where(ts & (v < floor) & has_ts, NEG_INF, f)
    if first and rule_out != "first_cap":
        cap = tsb + ids.max_initial_timestamp_index
        f = torch.where((v < tsb) | (v > cap), NEG_INF, f)
    return f


def _first_argmax(key, lo, hi):
    """(max, first index) of key[:, lo:hi] ((-inf, 2^31 - 1) if empty)."""
    R = key.shape[0]
    if hi <= lo:
        return (torch.full((R,), -float("inf")),
                torch.full((R,), 2 ** 31 - 1, dtype=torch.long))
    k, i = key[:, lo:hi].max(dim=1)   # torch's max: the first index
    return k, i + lo


def _better(k, i, k2, i2):
    take = (k2 > k) | ((k2 == k) & (i2 < i))
    return torch.where(take, k2, k), torch.where(take, i2, i)


def _tree_sum(parts):
    """The slices' sums as the kernel's lanes add them: lane q takes
    slice q, then adds lane q ^ 4, q ^ 2, q ^ 1; lane 0's total."""
    lanes = list(parts)
    for o in (4, 2, 1):
        lanes = [lanes[q] + lanes[q ^ o] for q in range(SLICES)]
    return lanes[0]


def _emulate(inp, vocab, first, with_ts, T, mistake=None):
    """The kernel's algorithm on the CPU, in place on a fresh state;
    ``mistake`` makes one of the named mistakes."""
    ids = _ids(vocab)
    st = _state(inp)
    logits = torch.from_numpy(inp["logits"])
    mask = torch.from_numpy(inp["mask"])
    R, V = logits.shape
    tsb, eot = ids.timestamp_begin, ids.eot
    f = _filtered(logits, ids, mask, first, with_ts, True, st.last_tok,
                  st.penult_tok, st.max_ts_tok,
                  mistake if mistake in ("pair", "monotonic", "first_cap")
                  else None)
    key = f
    if T > 0:
        pos = POS + 1 if mistake == "draw_pos" else POS
        u = DLP.uniform_draw_plain(SEED, torch.tensor(pos), R + 1, V)
        u = u[1:] if mistake == "draw_row" else u[:R]
        g = -torch.log(-torch.log(u))
        key = f * DC.inverse_temperature(T) + g
    slice_ = -(-V // SLICES)
    fm = {"t": [], "ts": []}
    parts = []
    for s in range(SLICES):
        lo, hi = s * slice_, min(V, (s + 1) * slice_)
        tlo, thi = lo, min(hi, tsb)          # the slice's text ids
        slo, shi = max(lo, tsb), hi          # its timestamp ids
        mt = (f[:, tlo:thi].amax(dim=1) if thi > tlo
              else torch.full((R,), -float("inf")))
        mts = (f[:, slo:shi].amax(dim=1) if shi > slo
               else torch.full((R,), -float("inf")))
        parts.append((mt, mts, *_first_argmax(key, tlo, thi),
                      *_first_argmax(key, slo, shi)))
    mt, mts, kt, it, kts, its = parts[0]
    for q in parts[1:]:                       # in slice order
        mt, mts = torch.maximum(mt, q[0]), torch.maximum(mts, q[1])
        kt, it = _better(kt, it, q[2], q[3])
        kts, its = _better(kts, its, q[4], q[5])
    m_ts = torch.maximum(mts, torch.tensor(NEG_INF)) if tsb > 0 else mts
    m_all = torch.maximum(mt, mts)
    v = torch.arange(V)[None, :]
    e_ts = torch.where(v >= tsb, torch.exp(f - m_ts[:, None]), 0.0)
    e_all = torch.exp(f - m_all[:, None])
    part_ts, part_all = [], []
    for s in range(SLICES):
        lo, hi = s * slice_, min(V, (s + 1) * slice_)
        part_ts.append(e_ts[:, lo:hi].sum(dim=1))
        part_all.append(e_all[:, lo:hi].sum(dim=1))
    sum_ts, sum_all = _tree_sum(part_ts), _tree_sum(part_all)
    n_text = float(min(tsb, V))
    s_force = sum_ts + n_text * torch.exp(NEG_INF - m_ts)
    ts_lp = torch.log(s_force) + m_ts
    force = (ts_lp > mt) if with_ts else torch.zeros(R, dtype=torch.bool)
    if mistake == "no_force":
        force = torch.zeros_like(force)
    if mistake == "force_inverted":
        force = ~force & with_ts
    unforced = torch.where((kt > kts) | ((kt == kts) & (it < its)), it, its)
    tok = torch.where(force, its, unforced)
    m_f = torch.where(force, m_ts, m_all)
    s_f = torch.where(force, s_force, sum_all)
    fin = st.finished.clone()
    if mistake != "finished_free":
        tok = torch.where(fin, eot, tok)
    f_tok = f.gather(1, tok[:, None])[:, 0]
    lp = (f_tok - m_f) - torch.log(s_f)
    st.sum_logprob.add_(torch.where(fin, 0.0, lp))
    st.finished.logical_or_(tok == eot)
    st.tokens[:, POS] = tok
    st.max_ts_tok.copy_(torch.where(
        tok >= tsb, torch.maximum(st.max_ts_tok, tok), st.max_ts_tok))
    st.penult_tok.copy_(st.last_tok)
    st.last_tok.copy_(tok)
    st.pos.add_(1)
    st.steps.add_(1)
    return st


def _same_state(got, want):
    """(integer state identical, sum_logprob error)."""
    same = all(torch.equal(getattr(got, k), getattr(want, k)) for k in
               ("tokens", "finished", "last_tok", "penult_tok",
                "max_ts_tok", "pos", "steps"))
    return same, _lp_err(got.sum_logprob.numpy(), want.sum_logprob.numpy())


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("first,with_ts,T", GRID)
def test_kernel_algorithm_matches_the_plain_choice(vocab, first, with_ts, T):
    inp = _inputs(vocab)
    same, err = _same_state(_emulate(inp, vocab, first, with_ts, T),
                            _plain(inp, vocab, first, with_ts, T))
    assert same and err < LP_TOL, err


#: each named mistake with the (first, with_ts, T) where these states
#: reach it
MISTAKES = [("pair", False, True, 0.0), ("monotonic", False, True, 0.0),
            ("first_cap", True, True, 0.0), ("no_force", False, True, 0.0),
            ("force_inverted", False, True, 0.0),
            ("draw_pos", False, True, 0.7), ("draw_row", False, True, 0.7),
            ("finished_free", False, True, 0.0)]


@pytest.mark.parametrize("mistake,first,with_ts,T", MISTAKES,
                         ids=[m[0] for m in MISTAKES])
def test_each_named_mistake_fails_the_hold(mistake, first, with_ts, T):
    inp = _inputs("wide")
    same, err = _same_state(
        _emulate(inp, "wide", first, with_ts, T, mistake),
        _plain(inp, "wide", first, with_ts, T))
    assert not same or err >= LP_TOL


def test_region_masked_everywhere_is_torch_bit_for_bit():
    """Row 2 (a closed pair) masks the whole timestamp region: the force
    rule's logsumexp sums exp(0) = 1 over every id, so it is NEG + log(V),
    which rounds back to NEG in f32, exactly as torch.logsumexp gives; and
    the force rule never fires there."""
    ids = _ids("wide")
    inp = _inputs("wide")
    logits = torch.from_numpy(inp["logits"])
    st = _state(inp)
    f = _filtered(logits, ids, torch.from_numpy(inp["mask"]), False, True,
                  True, st.last_tok, st.penult_tok, st.max_ts_tok)
    tsb = ids.timestamp_begin
    assert bool((f[2, tsb:] == NEG_INF).all())
    torch_lse = torch.logsumexp(
        torch.where(torch.arange(f.shape[1]) >= tsb, f, NEG_INF), dim=-1)
    m = torch.tensor(NEG_INF)
    ours = torch.log(torch.tensor(float(f.shape[1]))) + m
    assert float(torch_lse[2]) == float(ours) == NEG_INF
    assert float(torch_lse[2]) <= float(f[2, :tsb].max())


def test_present_marks_the_chosen_token_of_live_rows():
    inp = _inputs("narrow")
    st = _plain(inp, "narrow", False, True, 0.0, present=True)
    live = ~inp["finished"]
    tok = st.last_tok.numpy()
    got = st.present.numpy()
    assert got[np.arange(len(tok))[live], tok[live]].all()
    assert got.sum() == live.sum()


def test_choice_args_mirror_the_c_struct():
    """ops/decode_choice.py's ``_Args`` names csrc/decode_choice.cu's
    ``ChoiceArgs`` fields in their order."""
    src = (ROOT / "whisper_aries_tpu_torch" / "csrc"
           / "decode_choice.cu").read_text()
    body = src.split("struct ChoiceArgs {", 1)[1].split("};", 1)[0]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip().lstrip("*") for n in
                      re.sub(r"^(const\s+)?[\w ]+?[\s*]+(?=\w+\s*(,|$))", "",
                             decl).split(",")]
    assert names == [f[0] for f in DC._Args._fields_]


def test_kernel_wrappers_reject_cpu_operands():
    inp = _inputs("narrow")
    with pytest.raises(ValueError):
        DC.greedy_choice_kernel(torch.from_numpy(inp["logits"]), _state(inp),
                                _ids("narrow"), torch.from_numpy(inp["mask"]),
                                False, True, True, 0.0, 0)
    x = torch.zeros((6, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        VO.vocab_product_kernel(x, torch.zeros((300, 128),
                                               dtype=torch.bfloat16))


def test_inverse_temperature_is_the_f32_reciprocal():
    for T in (0.2, 0.4, 0.6, 0.8, 1.0, 1e-9):
        want = np.float32(1) / np.float32(max(T, 1e-6))
        assert DC.inverse_temperature(T) == float(want)


# ---------------------------------------------------------------------------
# the vocab product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,V,K", [(6, 1534, 128), (30, 51866, 64),
                                   (70, 513, 256)])
def test_vocab_product_matches_jax(M, V, K):
    """``vocab_logits_step``'s plain version (the final LayerNorm, then
    x.float() @ E.float().T) against the JAX package's LayerNorm and
    ``jnp.dot(x, emb.T, preferred_element_type=f32)`` on bf16 x and
    embedding: within 1e-5 of max |logit| (f32 sums in another order),
    below the "bf16-rounded logits" mistake."""
    rng = np.random.default_rng(M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    emb = (0.05 * rng.standard_normal((V, K))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(K)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    eb = jnp.asarray(emb, jnp.bfloat16)
    h = jax_layer_norm({"scale": jnp.asarray(scale, jnp.bfloat16),
                        "bias": jnp.asarray(bias, jnp.bfloat16)}, xb)
    want = np.asarray(jnp.dot(h, eb.T.astype(h.dtype),
                              preferred_element_type=jnp.float32))
    dec = {"ln": {"scale": torch.from_numpy(scale).bfloat16(),
                  "bias": torch.from_numpy(bias).bfloat16()},
           "tok_emb": torch.from_numpy(emb).bfloat16()}
    got = TW.vocab_logits_step(dec, torch.from_numpy(x).bfloat16()).numpy()
    assert got.shape == (M, V) and got.dtype == np.float32
    top = np.abs(want).max()
    err = np.abs(got - want).max() / top
    rounded = torch.from_numpy(want).bfloat16().float().numpy()
    mistake = np.abs(rounded - want).max() / top
    assert err < 1e-5 < mistake, (err, mistake)
    # the same bits as vocab_logits, whose product it replaces at decode
    assert torch.equal(torch.from_numpy(got), TW.vocab_logits(
        dec, torch.from_numpy(x).bfloat16()))


def test_vocab_logits_step_has_no_gradient():
    dec = {"ln": {"scale": torch.ones(64), "bias": torch.zeros(64)},
           "tok_emb": torch.randn(100, 64, requires_grad=True)}
    with pytest.raises(RuntimeError, match="no gradient"):
        TW.vocab_logits_step(dec, torch.randn(3, 64))
    with torch.no_grad():
        out = TW.vocab_logits_step(dec, torch.randn(2, 5, 64))
    assert out.shape == (2, 5, 100)

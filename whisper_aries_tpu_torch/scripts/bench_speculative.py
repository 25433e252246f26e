"""SYNTHETIC-ACCEPTANCE speculative-decode bench: never a headline number.

The counterpart of the TPU script ``scripts/bench_speculative.py`` (and,
in ``cost_sweep``, of ``scripts/probe_speculative.py``'s question). It
times the S-token verify step (``decoder_step_fused_multi``'s layers: one
graph replay of the decoder-layer kernels over S drafted tokens a window)
against the one-token step, at a FIXED synthetic acceptance count.
Acceptance is a property of real speech and real weights (prompt-lookup
n-gram reuse, ``decoding/drafter.py``); on random weights it is ~0 by
construction, so the speculative chain ADVANCES BY A SYNTHETIC COUNT
(``ARIES_SPEC_ACCEPT``, 3 of S = 4 by default) and measures only the
mechanics: verified tokens a second if acceptance were that rate. The
drafter runs on the card every step (its cost is included); its drafts
are scored but ignored for advancement.

    speculative chain: `steps` x (drafter, one verify replay at S, vocab
                       product, argmax; write ACC tokens, advance by ACC)
    base chain:        steps x ACC one-token replays (the same tokens)

Large-v3 at its published widths on the card (seeded random weights, the
decoder's dense layers int8 in the kernels' pack), B windows of random
encoder output (int8 cross K/V), a 3-token prompt prefilled into an int8
self cache of 256 positions. tokens/s(spec) / tokens/s(base) is the
speedup IF real acceptance averaged ACC; the deployment decision needs
the acceptance rate of real checkpoints, which the repository does not
have.

``cost_sweep`` answers probe_speculative.py's question for the fused
step: the verify step's replay ms at S in {1, 2, 4, 8} for B windows and
cost(S) / cost(1), beside the step's bytes / operations bound.

    python -m whisper_aries_tpu_torch.scripts.bench_speculative
        [--compute-type {bf16,f32}] [--device cpu]

``--compute-type f32`` runs the card's model at f32 (the engine's
``compute_type="f32"``): f32 params and activations, the decoder-layer
kernels' f32 residual stream at every S, the vocab product's "f32" path,
TF32 off. bf16 is the default.

Environment (the TPU script's knobs; its ARIES_SPEC_GROUP is TPU layout
and is not taken): ARIES_SPEC_S (4), ARIES_SPEC_ACCEPT (3),
ARIES_SPEC_BATCH (16), ARIES_SPEC_STEPS (24). With ``--device cpu`` a
narrow model (d 384, 2 layers) runs the plain versions at B <= 4 and
steps <= 4: a rehearsal of the plumbing, its times the host's.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from whisper_aries_tpu_torch.decoding.drafter import ngram_draft
from whisper_aries_tpu_torch.decoding.generate import _pack_fused_cache
from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.ops import decode_layers as DL
from whisper_aries_tpu_torch.scripts.common import (
    PEAK_BYTES,
    PEAK_OPS,
    card_line,
    device_of,
)
from whisper_aries_tpu_torch.utils.device import no_tf32

PROMPT = 3          # prompt tokens a window
CACHE_LEN = 256     # self-cache positions
SWEEP_S = (1, 2, 4, 8)
SWEEP_POS = 128     # the sweep's position: the middle of the cache
SWEEP_WARMUP, SWEEP_REPS = 3, 20  # replays a sweep point: untimed, timed
LABEL = ("SYNTHETIC-ACCEPTANCE speculative verify mechanics "
         "(NOT a real-speech speedup; acceptance is forced)")


def knobs() -> Dict[str, int]:
    k = {"S": int(os.environ.get("ARIES_SPEC_S", "4")),
         "ACC": int(os.environ.get("ARIES_SPEC_ACCEPT", "3")),
         "B": int(os.environ.get("ARIES_SPEC_BATCH", "16")),
         "steps": int(os.environ.get("ARIES_SPEC_STEPS", "24"))}
    if not 1 <= k["ACC"] <= k["S"]:
        raise ValueError(f"need 1 <= ARIES_SPEC_ACCEPT <= ARIES_SPEC_S, "
                         f"got {k['ACC']} and {k['S']}")
    if PROMPT + k["steps"] * k["ACC"] + k["S"] > CACHE_LEN:
        raise ValueError(f"{k['steps']} steps of {k['ACC']} tokens overrun "
                         f"the {CACHE_LEN}-position cache")
    return k


def verify_traffic(dims: W.WhisperDims, B: int, S: int, pos: int,
                   vs: int = 0, act: int = 2,
                   self_int8: bool = True) -> Dict[str, float]:
    """The least bytes one verify step moves (int8 weights and their
    vectors, the B windows' int8 cross K/V with scales, the self cache's
    live positions vs .. pos + S - 1 (int8 with scales, or ``act`` bytes a
    value where the cache is not int8), x in and out at ``act`` bytes an
    activation (4 for the f32 residual stream), each once) and the
    operations it does (the dense products of B S rows, each query's
    attention over its keys and the Ta cross keys)."""
    L, d, H = dims.n_text_layer, dims.n_text_state, dims.n_text_head
    ff, Ta, R = 4 * d, dims.n_audio_ctx, B * S
    w_bytes = L * (6 * d * d + 2 * d * ff + DL.vec_offsets(d, ff)[1] * 4)
    cross_bytes = L * B * 2 * H * Ta * (64 + 4)
    lane = 64 + 4 if self_int8 else 64 * act
    self_bytes = L * B * 2 * H * (pos + S - vs) * lane
    keys = sum(pos + s + 1 - vs for s in range(S))  # over the queries
    ops = (2 * R * L * (6 * d * d + 2 * d * ff)
           + 4 * L * H * 64 * (B * keys + R * Ta))
    return {"bytes": w_bytes + cross_bytes + self_bytes + 2 * R * d * act,
            "ops": ops}


def bound_ms(traffic: Dict[str, float]) -> float:
    """Bytes at the card's memory rate or operations at its bf16 tensor
    rate, whichever is longer (the published H100 SXM peaks)."""
    return max(traffic["bytes"] / PEAK_BYTES,
               traffic["ops"] / PEAK_OPS["bf16"]) * 1e3


#: the card's model dtype by ``--compute-type``
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class Setup:
    """The model, the windows' cross K/V and the prefilled self cache, at
    ``dtype`` on the card (bf16 or f32); the CPU model is f32."""

    def __init__(self, dev: torch.device, B: int, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        if dev.type == "cuda":
            dims = W.PRESETS["large-v3"]
        else:  # the TPU script's CPU model: 6 heads of 64, 2 layers
            dims = W.WhisperDims(80, 192, 384, 6, 2, 1000, 64, 384, 6, 2)
            dtype = torch.float32
        self.dev, self.dims, self.B, self.dtype = dev, dims, B, dtype
        full = W.init_params(dims, seed=seed, device=dev, dtype=dtype)
        self.params = W.fuse_decoder_qkv({"decoder": full["decoder"]})
        del full
        self.wpack = DL.pack_layer_weights(
            self.params["decoder"]["blocks"])
        g = torch.Generator(device=dev).manual_seed(seed)
        xa = (0.1 * torch.randn((B, dims.n_audio_ctx, dims.n_audio_state),
                                generator=g, device=dev)).to(dtype)
        self.cross = W.precompute_cross_kv_int8(self.params, xa, dims)
        del xa
        rng = np.random.default_rng(seed)
        self.prompt = torch.as_tensor(rng.integers(3, 200, (B, PROMPT)),
                                      dtype=torch.long, device=dev)
        cache = W.init_kv_cache(dims, B, dtype=dtype, max_len=CACHE_LEN,
                                device=dev)
        W.decoder_step(self.params, self.prompt, 0, cache, self.cross, dims)
        self.cache0 = _pack_fused_cache(cache, True)
        self.cache = {k: v.clone() for k, v in self.cache0.items()}

    def reset(self) -> None:
        """The prefilled cache again, in place (graphs hold its memory)."""
        for k, v in self.cache0.items():
            self.cache[k].copy_(v)

    def step(self, S: int):
        """The fused step at S queries a window: a graph replay on the
        card (captured once here), a direct call of the plain version on
        the CPU. Returns f(x (B S, d), pos) -> x."""
        H = self.dims.n_text_head
        if self.dev.type != "cuda":
            return lambda x, pos: DL.fused_decoder_layers(
                x, self.wpack, self.cache, self.cross, 0, pos, H, queries=S)
        graph = DL.DecodeStepGraph(self.wpack, self.cache, self.cross,
                                   self.B * S, H, 0, queries=S,
                                   dtype=self.dtype)
        return graph.run

    def embed(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """(B, S) tokens at positions pos .. pos + S - 1 -> x (B S, d)."""
        dec = self.params["decoder"]
        S = tokens.shape[1]
        at = torch.clamp(pos + torch.arange(S, device=self.dev), 0,
                         self.dims.n_text_ctx - 1)
        x = dec["tok_emb"][tokens] + dec["pos_emb"][at][None]
        return x.reshape(self.B * S, -1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chains(su: Setup, S: int, ACC: int, steps: int) -> Dict[str, float]:
    """Seconds of the speculative chain and of the base chain, each from
    the prefilled cache, after one untimed run of each."""
    dec = su.params["decoder"]
    verify, one = su.step(S), su.step(1)
    toks0 = torch.zeros((su.B, CACHE_LEN), dtype=torch.int32, device=su.dev)
    toks0[:, :PROMPT] = su.prompt.to(torch.int32)

    def spec():
        tokens, pos = toks0.clone(), PROMPT
        for _ in range(steps):
            draft = ngram_draft(tokens, pos, S, ngram=2, fallback=0)
            x = verify(su.embed(draft.long().clamp(min=0), pos), pos)
            nxt = W.vocab_logits_step(dec, x).view(su.B, S, -1).argmax(-1)
            # synthetic acceptance: ACC verified tokens, whatever matched
            tokens[:, pos:pos + ACC] = nxt[:, :ACC].to(torch.int32)
            pos += ACC
        return tokens

    def base():
        tokens, pos = toks0.clone(), PROMPT + 1
        for _ in range(steps * ACC):
            tok = tokens[:, pos - 1:pos].long()
            x = one(su.embed(tok, pos - 1), pos - 1)
            tokens[:, pos] = W.vocab_logits_step(dec, x).argmax(-1).to(
                torch.int32)
            pos += 1
        return tokens

    out = {}
    for name, fn in (("spec", spec), ("base", base)):
        for timed in (False, True):
            su.reset()
            _sync(su.dev)
            t0 = time.perf_counter()
            fn()
            _sync(su.dev)
            if timed:
                out[name] = time.perf_counter() - t0
    return out


def cost_sweep(su: Setup, sweep=SWEEP_S, pos: int = SWEEP_POS,
               reps: int = SWEEP_REPS) -> Dict[str, object]:
    """The fused step's replay ms at each S of ``sweep`` (B windows, one
    cache row each, S queries a row) by CUDA events over ``reps`` replays
    at ``pos`` after SWEEP_WARMUP; cost(S) / cost(1); each S's bound."""
    if su.dev.type != "cuda":
        raise ValueError("the cost sweep times the card")
    ms, bounds = {}, {}
    g = torch.Generator(device=su.dev).manual_seed(1)
    for S in sweep:
        step = su.step(S)
        x = torch.randn((su.B * S, su.dims.n_text_state), generator=g,
                        device=su.dev).to(su.dtype)
        for _ in range(SWEEP_WARMUP):
            step(x, pos)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            step(x, pos)
        end.record()
        end.synchronize()
        ms[S] = start.elapsed_time(end) / reps
        bounds[S] = bound_ms(verify_traffic(su.dims, su.B, S, pos,
                                            act=su.dtype.itemsize))
        del step
    base = ms[sweep[0]]
    return {"metric": "fused verify step, ms a graph replay by S "
                      f"(B {su.B} windows, pos {pos}, T {CACHE_LEN}, int8 "
                      f"self cache, {compute_type(su.dtype)})",
            "compute_type": compute_type(su.dtype),
            "ms": ms, "cost_over_s1": {S: v / base for S, v in ms.items()},
            "bound_ms": bounds}


def compute_type(dtype: torch.dtype) -> str:
    return next(k for k, v in DTYPES.items() if v == dtype)


def main(argv=None) -> Dict[str, object]:
    """Run both chains and (on the card) the cost sweep; print the
    synthetic-acceptance line, the sweep's line and the card line. Returns
    what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu: the plain versions at a narrow model")
    ap.add_argument("--compute-type", choices=tuple(DTYPES), default="bf16",
                    help="the card's model dtype (the CPU model is f32)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    k = knobs()
    S, ACC, B, steps = k["S"], k["ACC"], k["B"], k["steps"]
    if dev.type == "cpu":
        B, steps = min(B, 4), min(steps, 4)
    card = (card_line(dev) if dev.type == "cuda"
            else "cpu (plain versions: a rehearsal, the host's times)")
    with no_tf32():
        su = Setup(dev, B, dtype=DTYPES[args.compute_type])
        t = chains(su, S, ACC, steps)
        sweep = dict(cost_sweep(su), device=card) if dev.type == "cuda" \
            else None
    verified = steps * ACC * B
    line = {
        "metric": LABEL, "compute_type": compute_type(su.dtype),
        "s_draft": S, "synthetic_accept": ACC, "batch": B,
        "spec_s_per_step": t["spec"] / steps,
        "base_s_per_token": t["base"] / (steps * ACC),
        "verified_tokens_per_s_spec": verified / t["spec"],
        "verified_tokens_per_s_base": verified / t["base"],
        "speedup_if_acceptance_held": t["base"] / t["spec"],
        "device": card,
    }
    print(json.dumps(line), flush=True)
    out = {"bench": line}
    if sweep is not None:
        print(json.dumps(sweep), flush=True)
        out["sweep"] = sweep
    print(card, flush=True)
    return out


if __name__ == "__main__":
    main()

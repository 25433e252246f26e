"""What the three attention-micro probes share (``probe_qa_micro``,
``probe_qa_opt``, ``probe_qa_bisect``): the micro's shapes and inputs, the
variant flags, the plain version, the kernel launch
(``csrc/probe_qa.cu``), the holds and the variant loop of each ``main``.

The micro is one q-block of the TPU encoder megakernel's attention (H 20
heads, dh 64, bq 128 queries, Tp 1536 keys of which T 1500 are real, an
int8 O-projection (d, d), d 1280):

    lg = q^T k (f32)        -> mask keys >= T -> softmax (f32), bf16 probs
    att = pr v (f32)        -> bf16(att) x identity (bq, bq) -> attT
    of = bf16(wo)^T bf16(attT).reshape(d, bq)   (f32),  X = of[:8, :128]

and iteration i < reps adds (i mod 3 + 1) X to the (8, 128) answer. A
variant is a ``Spec``: where the mask comes from, where the normalisation
goes, whether the max is subtracted, the P.V layout, which phases run,
and whether the micro sits inside a branch on a runtime value. The card
runs one micro a block on every SM; the CPU (``device="cpu"``) runs the
plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.scripts import common

H, DH, BQ, TP, T = 20, 64, 128, 1536, 1500
D = H * DH
NEGF = float(np.finfo(np.float32).min)

# the flag values of csrc/probe_qa.cu
MASKS = ("none", "where", "row", "buffer")
NORMS = ("none", "before", "div", "rcp")
LAYOUTS = ("ident", "vmajor")
PHASES = ("all", "qk", "sm")

# limits of the (8, 128) answer, as a share of max |want|: bf16 flips of the
# probabilities averaged through P.V and the O-projection; the softmax-only
# answer is the probabilities themselves, one bf16 step each at most
LIMIT = 1e-3
LIMIT_SM = 2.0 ** -8
# limit of the checksum, as a share of the sum of |terms|
LIMIT_CHECKSUM = 1e-5
# the special-function rate of row 2 of the kernel table (exponentials/s)
EXP_RATE = 3.9e12


@dataclass(frozen=True)
class Spec:
    """One variant of the micro (the flags of ``csrc/probe_qa.cu``).

    mask: "where" (a select on the key index), "row" (an additive row
    computed from the key index), "buffer" (an additive row read from
    rmask[0]) or "none"; norm: "before" (pr = bf16(ex / sm)), "div" /
    "rcp" (pr = bf16(ex), att / sm or att * (1 / sm) after P.V) or "none"
    (pr = bf16(lg * 1e-3), no softmax); max_sub: exp(lg - max) or exp(lg);
    layout: "ident" (att (bq, dh), then the identity product) or "vmajor"
    (attT = v pr^T directly); phase: "all", "qk" (X from the logits) or
    "sm" (softmax only, on lgbuf; X from the probabilities); branch: the
    micro inside ``if (i >= gate)``, adding into the output each
    iteration."""

    mask: str = "where"
    norm: str = "before"
    max_sub: bool = True
    layout: str = "ident"
    phase: str = "all"
    branch: bool = False

    def flags(self):
        return (MASKS.index(self.mask), NORMS.index(self.norm),
                int(self.max_sub), LAYOUTS.index(self.layout),
                PHASES.index(self.phase), int(self.branch))


def fold_weight(reps: int) -> int:
    """sum over i < reps of (i mod 3 + 1)."""
    return sum(i % 3 + 1 for i in range(reps))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def inputs(dev: torch.device, extra: str, seed: int = 0) -> dict:
    """The TPU scripts' operands from the same numpy calls: q (H, dh, bq),
    k and v (H, dh, Tp) bf16 of 0.1 N(0, 1) (f64 draws rounded to bf16 as
    JAX rounds them), wo (d, d) int8 in [-127, 127), and ``extra``: "lgb"
    (probe_qa_micro: lgbuf (H, bq, Tp) f32 of N(0, 1)) or "rmask" (the
    other two: (8, Tp) f32, 0 below T and f32-min from T on)."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.from_numpy(0.1 * rng.standard_normal(shape)).to(
            torch.bfloat16).to(dev)

    ops = dict(q=bf16((H, DH, BQ)), k=bf16((H, DH, TP)), v=bf16((H, DH, TP)))
    ops["wo"] = torch.from_numpy(
        rng.integers(-127, 127, (D, D)).astype(np.int8)).to(dev)
    if extra == "lgb":
        ops["lgb"] = torch.from_numpy(
            rng.standard_normal((H, BQ, TP)).astype(np.float32)).to(dev)
    elif extra == "rmask":
        rmask = np.zeros((8, TP), np.float32)
        rmask[:, T:] = NEGF
        ops["rmask"] = torch.from_numpy(rmask).to(dev)
    else:
        raise ValueError(f"extra operand {extra!r} is not lgb or rmask")
    return ops


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def micro_plain(spec: Spec, q, k, v, wo, extra, keys: int = T,
                norm: Optional[str] = None, drop_head: bool = False):
    """One micro of ``spec``, a literal transcription of the TPU body: f32
    products of bf16 values, the same bf16 rounding points, the identity
    product as a product. Returns (X (8, 128) f32, everything the micro
    computes: the logits (qk), the probabilities (sm) or ``of``).
    ``extra`` is lgbuf or rmask. The named mistakes: ``keys`` Tp scores
    the padded keys, ``norm`` moves the normalisation, ``drop_head``
    drops the last head's P.V."""
    norm = spec.norm if norm is None else norm
    f32, bf = torch.float32, torch.bfloat16
    if spec.phase == "sm":
        lg = extra.to(f32)
    else:
        lg = torch.einsum("hci,hcj->hij", q.to(f32), k.to(f32))
    if spec.phase == "qk":
        return lg[0, :8, :128], lg
    if norm == "none":
        pr = (lg * 1e-3).to(bf)
    else:
        cols = torch.arange(TP, device=lg.device)
        if spec.mask == "where":
            lg = torch.where(cols < keys, lg, NEGF)
        elif spec.mask == "row":
            lg = lg + torch.where(cols < keys, 0.0, NEGF)
        elif spec.mask == "buffer":
            row = extra[0:1] if keys == T else torch.zeros_like(extra[0:1])
            lg = lg + row
        ex = torch.exp(lg - lg.amax(-1, keepdim=True)) if spec.max_sub \
            else torch.exp(lg)
        sm = ex.sum(-1, keepdim=True)                  # (H, bq, 1)
        pr = (ex / sm if norm == "before" else ex).to(bf)
    if spec.phase == "sm":
        return pr[0, :8, :128].to(f32), pr.to(f32)
    if spec.layout == "ident":
        att = torch.einsum("hij,hcj->hic", pr.to(f32), v.to(f32))
        if norm == "rcp":
            att = att * (1.0 / sm)
        elif norm == "div":
            att = att / sm
        if drop_head:
            att[-1] = 0.0
        eye = torch.eye(BQ, dtype=bf, device=att.device)
        attT = torch.einsum("hic,ik->hck", att.to(bf).to(f32), eye.to(f32))
    else:
        attT = torch.einsum("hcj,hij->hci", v.to(f32), pr.to(f32))
        if norm == "div":
            attT = attT / sm.reshape(H, 1, BQ)
        if drop_head:
            attT[-1] = 0.0
    attr = attT.to(bf).reshape(D, BQ)
    of = wo.to(bf).to(f32).T @ attr.to(f32)           # (d, bq)
    return of[:8, :128], of


def fold(x: torch.Tensor, reps: int) -> torch.Tensor:
    """The TPU loop's carry: c = c + X (i mod 3 + 1), in order, from 0."""
    c = torch.zeros((8, 128), dtype=torch.float32, device=x.device)
    for i in range(reps):
        c = c + x * float(i % 3 + 1)
    return c


def plain(spec: Spec, ops: dict, reps: int, extra: str) -> torch.Tensor:
    """The (8, 128) answer of ``reps`` iterations by the plain version."""
    x, _ = micro_plain(spec, ops["q"], ops["k"], ops["v"], ops["wo"],
                       ops[extra])
    return fold(x, reps)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _qa_fn():
    fn = cb.library("probe_qa").aries_probe_qa
    fn.argtypes = [_P] * 6 + [_I] * 10 + [_P] * 4
    fn.restype = _I
    return fn


def launch(spec: Spec, ops: dict, extra: str, reps: int,
           blocks: Optional[int] = None):
    """The kernel on CUDA operands, one micro a block, ``blocks`` blocks
    (default: the card's SM count): (out (blocks, 8, 128) f32, checksum
    (blocks,) f64). A branch variant runs its micro when the iteration is
    at least a runtime gate of 0, as the TPU's ``pl.when(i >= 0)``."""
    q, k, v, wo, x = (ops[n] for n in ("q", "k", "v", "wo", extra))
    dev = q.device
    cb.require(q, "q", torch.bfloat16, (H, DH, BQ))
    cb.require(k, "k", torch.bfloat16, (H, DH, TP), dev)
    cb.require(v, "v", torch.bfloat16, (H, DH, TP), dev)
    cb.require(wo, "wo", torch.int8, (D, D), dev)
    if extra == "lgb":
        cb.require(x, "lgb", torch.float32, (H, BQ, TP), dev)
    else:
        cb.require(x, "rmask", torch.float32, (8, TP), dev)
    blocks = cb.sm_count(q) if blocks is None else blocks
    attr = torch.empty((blocks, D, BQ), dtype=torch.bfloat16, device=dev)
    out = torch.empty((blocks, 8, 128), dtype=torch.float32, device=dev)
    checksum = torch.empty((blocks,), dtype=torch.float64, device=dev)
    lgb = cb.ptr(x) if extra == "lgb" else None
    rmask = cb.ptr(x) if extra == "rmask" else None
    cb.launch(_qa_fn(), q, "probe qa kernel", cb.ptr(q), cb.ptr(k), cb.ptr(v),
              cb.ptr(wo), lgb, rmask, *spec.flags(), T, reps, 0, blocks,
              cb.ptr(attr), cb.ptr(out), cb.ptr(checksum))
    return out, checksum


def counted_kernel(variants: Dict[str, Spec], extra: str) -> Callable:
    """A probe module's kernel wrapper: ``kernel(variant, ops, reps,
    blocks=None)`` launches the micro of ``variants[variant]`` and adds
    one to ``kernel.launches``."""

    def kernel(variant: str, ops: dict, reps: int, blocks: int = None):
        res = launch(variants[variant], ops, extra, reps, blocks)
        cb.count(kernel)
        return res

    kernel.launches = 0
    return kernel


def make_build(variants: Dict[str, Spec], extra: str, kernel: Callable):
    """A probe module's ``build(variant, reps, device=None)``: the function
    of (q, k, v, wo, lgb or rmask) giving the (8, 128) answer (block 0's
    on the card; the plain version on the CPU)."""

    def build(variant: str, reps: int, device=None):
        dev = common.device_of(device)
        if variant not in variants:
            raise ValueError(f"variant {variant!r} is not one of "
                             f"{list(variants)}")
        spec = variants[variant]

        def run(q, k, v, wo, x) -> torch.Tensor:
            ops = {n: torch.as_tensor(t).to(dev).contiguous() for n, t in
                   zip(("q", "k", "v", "wo", extra), (q, k, v, wo, x))}
            if dev.type == "cpu":
                return plain(spec, ops, reps, extra)
            return kernel(variant, ops, reps)[0][0]

        return run

    return build


# ---------------------------------------------------------------------------
# holds
# ---------------------------------------------------------------------------


def _err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def mistakes(spec: Spec, ops: dict, reps: int,
             extra: str) -> Dict[str, torch.Tensor]:
    """The (8, 128) answers of the named mistakes that apply to ``spec``."""
    args = (ops["q"], ops["k"], ops["v"], ops["wo"], ops[extra])
    out = {}
    if spec.phase == "qk":  # the logits of the next head
        x, _ = micro_plain(spec, ops["q"].roll(1, 0), *args[1:])
        out["next head's q"] = fold(x, reps)
        return out
    if spec.norm != "none":
        out["padded keys scored"] = fold(micro_plain(spec, *args, keys=TP)[0],
                                         reps)
    if spec.phase == "all":
        if spec.norm != "none":
            moved = "div" if spec.norm == "before" else "before"
            out["normalisation " + ("after" if moved == "div" else "before")
                + " P.V"] = fold(micro_plain(spec, *args, norm=moved)[0], reps)
        out["last head's P.V dropped"] = fold(
            micro_plain(spec, *args, drop_head=True)[0], reps)
    return out


def hold_variant(spec: Spec, ops: dict, reps: int, extra: str, got,
                 checksum=None) -> dict:
    """The (8, 128) answer ``got`` against the plain version, within
    ``LIMIT`` (``LIMIT_SM`` for the softmax only) of max |want|, each
    limit below the same error of the named mistakes; with ``checksum``
    (the kernel's, f64) also the checksum against the plain version's,
    within ``LIMIT_CHECKSUM`` of the sum of |terms|, below the error of a
    checksum of only what X reads."""
    x, whole = micro_plain(spec, ops["q"], ops["k"], ops["v"], ops["wo"],
                           ops[extra])
    want = fold(x, reps)
    limit = LIMIT_SM if spec.phase == "sm" else LIMIT
    res = common.hold(_err(got, want), limit,
                      {k: _err(m, want) for k, m in
                       mistakes(spec, ops, reps, extra).items()},
                      float((got - want).abs().max()))
    if checksum is not None:
        w = fold_weight(reps)
        want_cs = w * float(whole.double().sum())
        scale = w * float(whole.double().abs().sum())
        read = whole[0] if spec.phase != "all" else whole
        read_cs = w * float(read[:8, :128].double().sum())
        res["checksum"] = common.hold(
            abs(float(checksum) - want_cs) / scale, LIMIT_CHECKSUM,
            {"only the rows the output reads": abs(read_cs - want_cs) / scale},
            abs(float(checksum) - want_cs))
        res["ok"] = res["ok"] and res["checksum"]["ok"]
    return res


# ---------------------------------------------------------------------------
# operations and the yardstick
# ---------------------------------------------------------------------------


def micro_ops(spec: Spec) -> dict:
    """The operations of one micro: ``products`` (bf16 multiply-adds x 2)
    the TPU body does, ``done`` those the kernel does (the second pass
    recomputes QK^T), ``exps`` the exponentials the function needs and
    ``exps_done`` those the kernel takes."""
    qk = 2 * H * BQ * TP * DH
    if spec.phase == "qk":
        return dict(products=qk, done=qk, exps=0, exps_done=0)
    softmax = spec.norm != "none"
    exps = H * BQ * TP if softmax else 0
    two_pass = spec.phase == "sm" or (softmax and spec.max_sub)
    exps_done = exps * (2 if spec.phase == "sm" or spec.norm == "before"
                        else 1)
    if spec.phase == "sm":
        return dict(products=0, done=0, exps=exps, exps_done=exps_done)
    prod = 2 * qk + (2 * H * DH * BQ * BQ if spec.layout == "ident" else 0) \
        + 2 * D * D * BQ
    return dict(products=prod, done=prod + (qk if two_pass else 0),
                exps=exps, exps_done=exps_done)


def bound(spec: Spec, extra: str, reps: int, blocks: int) -> dict:
    """The least time of one launch (``reps`` micros on each of ``blocks``
    blocks) on the card: the operations at the bf16 peak or the bytes read
    once and written once at the memory rate, whichever is longer; the
    exponentials at ``EXP_RATE`` beside."""
    ops = micro_ops(spec)
    n = reps * blocks
    nbytes = (H * DH * BQ + 2 * H * DH * TP) * 2 + D * D + blocks * (
        8 * 128 * 4 + 8)
    nbytes += H * BQ * TP * 4 if extra == "lgb" and spec.phase == "sm" else 0
    nbytes += 8 * TP * 4 if extra == "rmask" else 0
    ms_ops = n * ops["products"] / common.PEAK_OPS["bf16"] * 1e3
    ms_bytes = nbytes / common.PEAK_BYTES * 1e3
    return dict(bound_ms=max(ms_ops, ms_bytes),
                bound_by="operations" if ms_ops >= ms_bytes else "bytes",
                ops=n * ops["products"], ops_done=n * ops["done"],
                exps=n * ops["exps"], exps_done=n * ops["exps_done"],
                exp_ms=n * ops["exps"] / EXP_RATE * 1e3, bytes=nbytes)


def yardstick_ms(dev: torch.device, ops: dict, batch: int) -> dict:
    """Two PyTorch calls doing the work of ``batch`` micros: one
    scaled_dot_product_attention at (batch, H, bq, Tp keys, dh) bf16 with
    the key mask (scale 1), then one torch.matmul of the O-projection
    (d x d by d x batch bq). No one call computes the micro."""
    import torch.nn.functional as F

    qb = ops["q"].transpose(1, 2).unsqueeze(0).expand(batch, -1, -1, -1)
    kb = ops["k"].transpose(1, 2).unsqueeze(0).expand(batch, -1, -1, -1)
    vb = ops["v"].transpose(1, 2).unsqueeze(0).expand(batch, -1, -1, -1)
    qb, kb, vb = (x.contiguous() for x in (qb, kb, vb))
    mask = (torch.arange(TP, device=dev) < T).view(1, 1, 1, TP)
    wo_t = ops["wo"].to(torch.bfloat16).T.contiguous()
    attr = torch.randn((D, batch * BQ), device=dev).to(torch.bfloat16)

    def sdpa():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask,
                                              scale=1.0)

    def oproj():
        return wo_t @ attr

    s_ms, o_ms = common.best_ms(sdpa), common.best_ms(oproj)
    both = common.best_ms(lambda: (sdpa(), oproj()))
    return dict(batch=batch, sdpa_ms=s_ms, oproj_ms=o_ms, ms=both)


# ---------------------------------------------------------------------------
# the probes' main
# ---------------------------------------------------------------------------


def main_for(doc: str, variants: Dict[str, Spec], twins: Dict[str, str],
             build: Callable, kernel: Callable, extra: str, default_reps: int,
             rel_vs_base: bool, argv=None) -> List[dict]:
    """A probe module's ``main`` (--device, --reps: the TPU script's
    default). Each variant once through ``build`` (the first call), then on
    the card: best-of-3 time, us per iteration, the 2 x reps launch against
    the reps one, every block's answer and checksum equal, the plain
    version's time; every variant held against the plain version. Prints
    one line a variant, as the TPU scripts do (with rel_vs_base for opt and
    bisect)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--reps", type=int, default=default_reps)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    reps = args.reps
    print(f"device={common.card_line(dev)} reps={reps}", flush=True)
    ops = inputs(dev, extra)
    operands = tuple(ops[n] for n in ("q", "k", "v", "wo", extra))
    results, base = [], None
    for name, spec in variants.items():
        f = build(name, reps, dev)
        t0 = time.time()
        y = f(*operands)
        res = dict(variant=name, spec=spec.__dict__.copy(), reps=reps,
                   first_s=time.time() - t0)
        if name in twins:
            res["twin"] = twins[name]
        if dev.type == "cuda":
            out, cs = kernel(name, ops, reps)
            torch.cuda.synchronize()
            res["blocks"] = out.shape[0]
            res["blocks_equal"] = bool((out == out[0]).all()) and bool(
                (cs == cs[0]).all())
            ms = common.best_ms(lambda: f(*operands))
            ms2 = common.best_ms(lambda: kernel(name, ops, 2 * reps))
            res.update(ms=ms, us_per_iter=ms * 1e3 / reps, ms_2x=ms2,
                       scaling=ms2 / ms, plain_ms=common.best_ms(
                           lambda: plain(spec, ops, reps, extra)),
                       **bound(spec, extra, reps, out.shape[0]))
            res.update(hold_variant(spec, ops, reps, extra, out[0],
                                    float(cs[0])))
            res["ok"] = res["ok"] and res["blocks_equal"] and \
                1.8 <= res["scaling"] <= 2.2
        else:
            res.update(hold_variant(spec, ops, reps, extra, y))
        if base is None:
            base = y
        line = f"{name:9}: "
        if "us_per_iter" in res:
            line += f"{res['us_per_iter']:8.1f} us/iter "
        if rel_vs_base:
            res["rel_vs_base"] = _err(y, base)
            line += f"rel_vs_base={res['rel_vs_base']:.2e} "
        line += common.held_text(res)
        if "checksum" in res:
            line += "; checksum " + common.held_detail(res["checksum"])
        if dev.type == "cuda":
            line += (f"; {res['blocks']} blocks "
                     f"{'equal' if res['blocks_equal'] else 'DIFFER'}, "
                     f"2 x reps {res['scaling']:.3f}x")
        if name in twins:
            line += f"; {twins[name]}"
        print(line, flush=True)
        results.append(res)
    return results

"""Golden end-to-end parity harness of the port.

The counterpart of the JAX repo's ``scripts/parity_vs_goldens.py``. It
runs golden jobs (a directory a job, each holding the reference
pipeline's ``<stem>.json`` and ``<stem>.srt`` / ``<stem>.html``) through
the port's ``run_pipeline`` and reports, a job:

  * structural parity: our JSON / SRT / HTML outputs exist, parse and
    carry the golden schema (5-key segments, 5-key metadata, SRT
    numbering);
  * WER against the golden transcript (eval/wer.py);
  * segment-timestamp deltas against the golden segments (greedy time
    overlap matching; mean / max |start| and |end| error over matched
    pairs).

Modes:
  * MOCK (no ``--audio-dir``, or a job whose recording is not there): the
    job runs on synthetic audio of the golden's duration (capped at
    ``--mock-cap-seconds``); with no checkpoint the engine is a tiny
    random-weight one. This checks the pipeline's contract end to end
    (plumbing, renderers, the report); WER is reported but meaningless and
    never gated.
  * REAL (``--audio-dir`` with the source recordings, named by the golden
    stems with any supported extension, and a checkpoint for
    ``--model``): WER and timestamp deltas are gated by ``--max-wer`` and
    ``--max-ts-delta``.

    python -m whisper_aries_tpu_torch.scripts.parity_vs_goldens
        --goldens DIR [--audio-dir DIR] [--model SIZE|DIR] [--out DIR]
        [--max-wer 0.15] [--max-ts-delta 1.0] [--jobs N]
        [--mock-cap-seconds 45] [--device cpu]

``--goldens`` has no default: the repository holds no golden jobs. With no
golden directory, or none with a job, it prints the error and exits 1. It
prints one JSON report line a job and a summary line; the exit code is 1
also when a structure check fails or, in the REAL mode, a gate. The engine
and the diarizer run on the card unless ``--device cpu``; without a card
and without ``--device cpu`` the engine raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

AUDIO_EXTS = (".wav", ".mp3", ".flac", ".ogg", ".m4a", ".mp4", ".webm",
              ".mkv", ".aac", ".wma")


def find_golden_jobs(goldens_dir: Path) -> List[Dict[str, Any]]:
    """[{job_id, stem, json_path, srt_path, html_path, golden}] a job."""
    jobs = []
    for job_dir in sorted(p for p in goldens_dir.iterdir() if p.is_dir()):
        js = sorted(job_dir.glob("*.json"))
        if not js:
            continue
        stem = js[0].stem
        jobs.append({
            "job_id": job_dir.name,
            "stem": stem,
            "json_path": js[0],
            "srt_path": job_dir / f"{stem}.srt",
            "html_path": job_dir / f"{stem}.html",
            "golden": json.loads(js[0].read_text(encoding="utf-8")),
        })
    return jobs


def synth_audio_for(golden: Dict[str, Any], cap_s: float) -> np.ndarray:
    """Synthetic stand-in audio of the golden's duration (mock mode)."""
    segs = golden.get("segments", [])
    dur = max((float(s.get("end", 0.0)) for s in segs), default=10.0) + 1.0
    dur = min(dur, cap_s)
    sr = 16000
    t = np.arange(int(dur * sr)) / sr
    rng = np.random.default_rng(0)
    x = (0.25 * np.sin(2 * np.pi * 220 * t)
         * (0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * t))).astype(np.float32)
    x += 0.01 * rng.standard_normal(len(t)).astype(np.float32)
    return x


def check_structure(golden: Dict[str, Any], ours: Dict[str, Any],
                    out_files: Dict[str, str]) -> List[str]:
    """Structural parity failures (empty list == parity)."""
    problems: List[str] = []
    if set(ours) != {"segments", "metadata"}:
        problems.append(f"json top-level keys {sorted(ours)}")
    seg_keys = {"text", "start", "end", "speaker", "confidence"}
    for i, s in enumerate(ours.get("segments", [])):
        if set(s) != seg_keys:
            problems.append(f"segment {i} keys {sorted(s)}")
            break
    meta_keys = {"audio_file", "pipeline_version", "confidence_threshold",
                 "language", "total_segments"}
    if set(ours.get("metadata", {})) != meta_keys:
        problems.append(
            f"metadata keys {sorted(ours.get('metadata', {}))}")
    for fmt in ("json", "srt", "html"):
        p = out_files.get(fmt)
        if not p or not Path(p).exists():
            problems.append(f"missing output {fmt}")
    srt = out_files.get("srt")
    if srt and Path(srt).exists():
        body = Path(srt).read_text(encoding="utf-8")
        n = len(ours.get("segments", []))
        if n and f"{n}\n" not in body:
            problems.append("srt numbering does not reach segment count")
    return problems


def _no_match() -> Dict[str, Any]:
    return {"matched": 0, "mean_start_delta": None, "max_start_delta": None,
            "mean_end_delta": None, "max_end_delta": None}


def match_timestamps(golden_segs: List[dict], our_segs: List[dict]
                     ) -> Dict[str, Any]:
    """Greedy overlap matching; |start| / |end| deltas over matched pairs."""
    if not golden_segs or not our_segs:
        return _no_match()
    ds, de = [], []
    used = set()
    for g in golden_segs:
        best, best_ov = None, 0.0
        for i, s in enumerate(our_segs):
            if i in used:
                continue
            ov = min(g["end"], s["end"]) - max(g["start"], s["start"])
            if ov > best_ov:
                best, best_ov = i, ov
        if best is not None:
            used.add(best)
            ds.append(abs(our_segs[best]["start"] - g["start"]))
            de.append(abs(our_segs[best]["end"] - g["end"]))
    if not ds:
        return _no_match()
    return {
        "matched": len(ds),
        "mean_start_delta": round(float(np.mean(ds)), 3),
        "max_start_delta": round(float(np.max(ds)), 3),
        "mean_end_delta": round(float(np.mean(de)), 3),
        "max_end_delta": round(float(np.max(de)), 3),
    }


def run_job(job: Dict[str, Any], args, transcriber, cfg) -> Dict[str, Any]:
    """One golden job through ``run_pipeline`` with ``transcriber`` (the
    diarizer built there, on ``args.device``); its report."""
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.eval.wer import wer
    from whisper_aries_tpu_torch.pipeline.run import run_pipeline

    golden = job["golden"]
    lang = golden.get("metadata", {}).get("language") or None

    audio_path: Optional[Path] = None
    if args.audio_dir:
        for ext in AUDIO_EXTS:
            cand = Path(args.audio_dir) / f"{job['stem']}{ext}"
            if cand.exists():
                audio_path = cand
                break
    mock = audio_path is None
    if mock:
        fd, name = tempfile.mkstemp(suffix=".wav",
                                    prefix=f"{job['stem'][:16]}_")
        os.close(fd)
        write_wav(name, synth_audio_for(golden, args.mock_cap_seconds),
                  16000)
        audio_path = Path(name)

    out_dir = Path(args.out) / job["job_id"]
    try:
        res = run_pipeline(
            str(audio_path),
            output_dir=str(out_dir),
            formats=("html", "json", "srt"),
            language=lang,
            run_llm_analysis=False,
            transcriber=transcriber,
            config=cfg,
            device=getattr(args, "device", None),
        )
    finally:
        if mock:
            audio_path.unlink(missing_ok=True)
    report: Dict[str, Any] = {
        "job": job["job_id"], "stem": job["stem"], "mock_audio": mock,
        "pipeline_success": bool(res.get("success")),
    }
    if not res.get("success"):
        report["error"] = res.get("error")
        return report

    ours = json.loads(
        Path(res["outputs"]["json"]).read_text(encoding="utf-8"))
    report["structure_problems"] = check_structure(
        golden, ours, res["outputs"])
    golden_text = " ".join(s["text"] for s in golden.get("segments", []))
    our_text = " ".join(s["text"] for s in ours.get("segments", []))
    report["wer"] = round(wer(golden_text, our_text,
                              language=lang or "en"), 4)
    report["timestamps"] = match_timestamps(
        golden.get("segments", []), ours.get("segments", []))
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--goldens", default=None,
                    help="directory of golden jobs (required: the "
                         "repository holds none)")
    ap.add_argument("--audio-dir", default=None,
                    help="directory with the real source recordings "
                         "(<stem>.<ext>); absent files fall back to mock")
    ap.add_argument("--model", default=None,
                    help="model size or checkpoint directory (default: "
                         "tiny random-weight mock engine when no real "
                         "checkpoint exists)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=0, help="limit job count")
    ap.add_argument("--max-wer", type=float, default=0.15)
    ap.add_argument("--max-ts-delta", type=float, default=1.0)
    ap.add_argument("--mock-cap-seconds", type=float, default=45.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.goldens is None or not Path(args.goldens).is_dir():
        print(json.dumps({"error": f"goldens dir missing: {args.goldens}"}))
        return 1
    jobs = find_golden_jobs(Path(args.goldens))
    if args.jobs:
        jobs = jobs[: args.jobs]
    if not jobs:
        print(json.dumps({"error": f"no golden jobs in {args.goldens}"}))
        return 1
    if args.out is None:
        args.out = tempfile.mkdtemp(prefix="parity_goldens_")

    # one engine for all jobs
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.models.loader import resolve_model_dir
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    model = args.model
    if model is None:
        model = "large-v3" if resolve_model_dir("large-v3") else "tiny"
    real_weights = resolve_model_dir(model) is not None
    cfg = load_config()
    if not real_weights:
        # mock mode: random weights produce meaningless text anyway; keep
        # the contract check cheap
        cfg.decode.max_new_tokens = 24
    transcriber = AriesTranscriber(
        model_size=model, allow_random=True, config=cfg, device=args.device,
        windows_per_device=None if real_weights else 2,
    )

    reports = []
    for job in jobs:
        rep = run_job(job, args, transcriber, cfg)
        rep["real_weights"] = real_weights
        print(json.dumps(rep, ensure_ascii=False), flush=True)
        reports.append(rep)

    structural_fail = [r["job"] for r in reports
                       if r.get("structure_problems")
                       or not r.get("pipeline_success")]
    gate = real_weights and args.audio_dir is not None
    wer_fail = [r["job"] for r in reports
                if gate and not r.get("mock_audio")
                and r.get("wer", 1.0) > args.max_wer]
    ts_fail = [
        r["job"] for r in reports
        if gate and not r.get("mock_audio")
        and (r.get("timestamps", {}).get("mean_start_delta") or 0)
        > args.max_ts_delta
    ]
    summary = {
        "jobs": len(reports),
        "mode": "real" if gate else "mock",
        "structural_failures": structural_fail,
        "wer_failures": wer_fail,
        "timestamp_failures": ts_fail,
    }
    print(json.dumps(summary))
    return 1 if (structural_fail or (gate and (wer_fail or ts_fail))) else 0


if __name__ == "__main__":
    raise SystemExit(main())

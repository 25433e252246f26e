"""Whisper tokenizer: GPT-2-style byte-level BPE + Whisper's special tokens.

Replaces the tokenizer hidden inside faster-whisper/CTranslate2 (reference
SURVEY §2.3 N1/N2). Loads the standard ``vocab.json`` + ``merges.txt`` files
that ship with every public Whisper checkpoint (HF layout); no network access
needed at runtime beyond having the checkpoint on disk.

The special-token layout is derived, not hardcoded per model:
multilingual vocabularies place ``<|endoftext|>`` at the end of the base BPE
table, followed by ``<|startoftranscript|>``, one token per language
(99 for large-v2-era models, 100 incl. Cantonese for large-v3), task tokens,
``<|startoflm|>``, ``<|startofprev|>``, ``<|nospeech|>``,
``<|notimestamps|>``, and 1501 timestamp tokens <|0.00|>..<|30.00|> in 20 ms
steps. Tests pin the resulting ids against the publicly known Whisper id
tables (e.g. v3: sot=50258, transcribe=50360, first timestamp=50365).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

# Whisper's language registry in canonical token order. v2-era multilingual
# models use the first 99; large-v3 adds "yue".
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)

N_TIMESTAMP_TOKENS = 1501  # <|0.00|> .. <|30.00|> in 0.02 s steps
TIME_PRECISION = 0.02


@dataclass(frozen=True)
class SpecialTokens:
    """Derived id table for a Whisper vocabulary."""

    n_vocab: int
    eot: int
    sot: int
    language_tokens: Dict[str, int]
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int  # id of <|0.00|>

    @property
    def num_languages(self) -> int:
        return len(self.language_tokens)

    def language_of(self, token_id: int) -> Optional[str]:
        for code, tid in self.language_tokens.items():
            if tid == token_id:
                return code
        return None

    def timestamp_to_seconds(self, token_id: int) -> float:
        return (token_id - self.timestamp_begin) * TIME_PRECISION

    def seconds_to_timestamp(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / TIME_PRECISION))

    def is_timestamp(self, token_id: int) -> bool:
        return token_id >= self.timestamp_begin

    def sot_sequence(self, language: Optional[str] = None,
                     task: str = "transcribe",
                     no_timestamps: bool = False) -> List[int]:
        """<|startoftranscript|> [<|lang|> <|task|>] [<|notimestamps|>]."""
        seq = [self.sot]
        if language is not None:
            if language not in self.language_tokens:
                raise ValueError(f"unknown language: {language!r}")
            seq.append(self.language_tokens[language])
            seq.append(self.translate if task == "translate" else self.transcribe)
        if no_timestamps:
            seq.append(self.no_timestamps)
        return seq

    @property
    def all_special_ids(self) -> List[int]:
        ids = [self.eot, self.sot, self.translate, self.transcribe,
               self.sot_lm, self.sot_prev, self.no_speech, self.no_timestamps]
        ids += list(self.language_tokens.values())
        return ids

    # Tokens never produced during transcription (CTranslate2's
    # suppress_sequences equivalent; see openai/whisper's non_speech_tokens).
    def non_speech_tokens(self, encoder) -> List[int]:
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + [
            "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", '("',
            "((", "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪",
        ]
        ids = set()
        for sym in symbols + [" " + s for s in symbols]:
            toks = encoder(sym)
            if len(toks) == 1:
                ids.add(toks[0])
        for extra in ("♩", "♪", "♫", "♬", "♭", "♮", "♯"):
            toks = encoder(extra)
            if len(toks) == 1:
                ids.add(toks[0])
            toks = encoder(" " + extra)
            if len(toks) == 1:
                ids.add(toks[0])
        return sorted(ids)


def build_special_tokens(n_base_vocab: int, num_languages: int,
                         english: bool = False) -> SpecialTokens:
    """Layout specials after the base BPE table.

    Multilingual models append <|endoftext|> after the base table; the
    English-only ``.en`` models reuse GPT-2's own <|endoftext|> (the last
    base id), shifting every special down by one — e.g. tiny.en:
    eot=50256, sot=50257, transcribe=50358, timestamps from 50363,
    n_vocab=51864.
    """
    eot = n_base_vocab - 1 if english else n_base_vocab
    sot = eot + 1
    lang0 = sot + 1
    langs = {LANGUAGES[i]: lang0 + i for i in range(num_languages)}
    translate = lang0 + num_languages
    transcribe = translate + 1
    sot_lm = transcribe + 1
    sot_prev = sot_lm + 1
    no_speech = sot_prev + 1
    no_timestamps = no_speech + 1
    timestamp_begin = no_timestamps + 1
    n_vocab = timestamp_begin + N_TIMESTAMP_TOKENS
    return SpecialTokens(
        n_vocab=n_vocab, eot=eot, sot=sot, language_tokens=langs,
        translate=translate, transcribe=transcribe, sot_lm=sot_lm,
        sot_prev=sot_prev, no_speech=no_speech, no_timestamps=no_timestamps,
        timestamp_begin=timestamp_begin,
    )


# ---------------------------------------------------------------------------
# Byte-level BPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode mapping (printable stand-ins for
    control/whitespace bytes)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_GPT2_SPLIT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


class WhisperTokenizer:
    """Byte-level BPE encoder/decoder with Whisper specials.

    Files: ``vocab.json`` (token->id) and ``merges.txt`` (one merge per
    line), the layout shipped with public Whisper checkpoints.
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 num_languages: Optional[int] = None, english: bool = False):
        self.encoder_map = dict(vocab)
        self.decoder_map = {v: k for k, v in self.encoder_map.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        n_base = len(self.encoder_map)
        if english and "<|endoftext|>" not in self.encoder_map:
            # .en models reuse GPT-2's own <|endoftext|> as the last base id;
            # if the caller stripped it from the vocab (from_pretrained does),
            # count it back so eot lands at 50256, not 50255.
            n_base += 1
        if num_languages is None:
            num_languages = 99  # v2-era default; from_pretrained passes exact
        self.specials = build_special_tokens(n_base, num_languages,
                                             english=english)
        self._cache: Dict[str, List[str]] = {}
        import regex

        self._pat = regex.compile(_GPT2_SPLIT_PATTERN)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str) -> "WhisperTokenizer":
        """Load from a checkpoint directory containing vocab.json+merges.txt
        (and optionally config.json/added_tokens.json)."""
        p = Path(path)
        vocab = json.loads((p / "vocab.json").read_text(encoding="utf-8"))
        merges: List[Tuple[str, str]] = []
        for line in (p / "merges.txt").read_text(encoding="utf-8").splitlines():
            if line.startswith("#version") or not line.strip():
                continue
            a, b = line.split(" ", 1)
            merges.append((a, b))
        # Strip any specials that HF bakes into vocab.json.
        base_vocab = {k: v for k, v in vocab.items()
                      if not (k.startswith("<|") and k.endswith("|>"))}
        num_languages = None
        english = False
        # Most reliable: the model config's vocab_size determines the layout
        # exactly (51865=v2/99 langs, 51866=v3/100, 51864=.en English-only).
        cfg_file = p / "config.json"
        if cfg_file.exists():
            try:
                n_vocab = json.loads(cfg_file.read_text(encoding="utf-8")).get(
                    "vocab_size"
                )
                if n_vocab == 51864:
                    num_languages, english = 99, True
                elif n_vocab:
                    num_languages = n_vocab - 51766
            except Exception:
                pass
        if num_languages is None:
            added = p / "added_tokens.json"
            if added.exists():
                extra = json.loads(added.read_text(encoding="utf-8"))
                langs = [k for k in extra if k.startswith("<|") and len(k) <= 8
                         and k[2:-2] in LANGUAGES]
                if langs:
                    num_languages = len(langs)
        if num_languages is None or not (1 <= num_languages <= len(LANGUAGES)):
            num_languages = 100 if "<|yue|>" in vocab else 99
        return cls(base_vocab, merges, num_languages=num_languages,
                   english=english)

    # -- BPE core ------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        if len(word) == 1:
            self._cache[token] = [token]
            return [token]
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda pr: self.bpe_ranks.get(pr, 1 << 60))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> base BPE ids (no specials added)."""
        ids: List[int] = []
        for piece in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                tid = self.encoder_map.get(sub)
                if tid is None:
                    # Unknown merge result: fall back to per-character ids.
                    for ch in sub:
                        if ch in self.encoder_map:
                            ids.append(self.encoder_map[ch])
                else:
                    ids.append(tid)
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        """Ids -> text. Specials (>= eot) are skipped or rendered."""
        sp = self.specials
        pieces: List[str] = []
        for tid in ids:
            tid = int(tid)
            if tid >= sp.eot:
                if skip_special:
                    continue
                pieces.append(self._render_special(tid))
            else:
                pieces.append(self.decoder_map.get(tid, ""))
        text = "".join(pieces)
        raw = bytearray(self.byte_decoder.get(c, 0) for c in text)
        return raw.decode("utf-8", errors="replace")

    def _render_special(self, tid: int) -> str:
        sp = self.specials
        if tid == sp.eot:
            return "<|endoftext|>"
        if tid == sp.sot:
            return "<|startoftranscript|>"
        if tid == sp.translate:
            return "<|translate|>"
        if tid == sp.transcribe:
            return "<|transcribe|>"
        if tid == sp.sot_lm:
            return "<|startoflm|>"
        if tid == sp.sot_prev:
            return "<|startofprev|>"
        if tid == sp.no_speech:
            return "<|nospeech|>"
        if tid == sp.no_timestamps:
            return "<|notimestamps|>"
        if tid >= sp.timestamp_begin:
            return f"<|{sp.timestamp_to_seconds(tid):.2f}|>"
        lang = sp.language_of(tid)
        if lang:
            return f"<|{lang}|>"
        return ""

    def non_speech_tokens(self, encoder=None) -> List[int]:
        """Default suppress set (suppress_tokens=-1 expansion). The engine
        calls this on the TOKENIZER (day-1 load path — caught by
        tests/test_checkpoint_load.py); delegate to the specials table
        with this tokenizer's own encoder by default."""
        return self.specials.non_speech_tokens(encoder or self.encode)

    # convenience pass-throughs
    @property
    def eot(self) -> int:
        return self.specials.eot

    @property
    def sot(self) -> int:
        return self.specials.sot

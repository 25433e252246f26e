"""Greedy and beam decoding, Whisper's logit rules, tokenizer and segment
parsing.

The JAX package's re-exports, resolved at first use (module
``__getattr__``): ``generate`` imports the beam kernels' wrappers, whose
module imports ``decoding.logit_filters``, so importing it here would
close a cycle."""

import importlib

_EXPORTS = {
    "tokenizer": ("LANGUAGES", "SpecialTokens", "WhisperTokenizer",
                  "build_special_tokens"),
    "generate": ("DecodeSpecialIds", "beam_search_decode",
                 "build_suppress_mask", "detect_language_logits",
                 "greedy_decode"),
    "segments_parse": ("compression_ratio", "parse_window_tokens",
                       "window_quality"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

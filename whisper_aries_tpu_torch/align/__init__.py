from whisper_aries_tpu_torch.align.word_align import (
    add_word_timestamps,
    dtw_path,
    find_word_alignments,
    split_tokens_into_words,
)

__all__ = [
    "add_word_timestamps",
    "dtw_path",
    "find_word_alignments",
    "split_tokens_into_words",
]

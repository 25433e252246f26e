"""Greedy and beam decoding, Whisper's logit rules, tokenizer and segment
parsing."""

"""Greedy decoding, tokenizer and segment parsing."""

"""Data of the port. Only the offline byte tokenizer is ported so far
(:mod:`.text.tokenizers`)."""

"""Text data: the offline byte tokenizer."""
from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer

__all__ = ["ByteTokenizer"]

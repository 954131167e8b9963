"""Data of the port: the map-style batch loader (:mod:`.loader`) and the
offline byte tokenizer (:mod:`.text.tokenizers`)."""
from perceiver_io_tpu_torch.data.loader import DataLoader, default_collate

__all__ = ["DataLoader", "default_collate"]

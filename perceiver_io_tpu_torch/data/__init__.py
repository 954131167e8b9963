"""Data of the port: the map-style batch loader (:mod:`.loader`), the
text pipelines (:mod:`.text`: tokenizers, collators, the cached and
streaming data modules), the MIDI event codec
and symbolic-audio data modules (:mod:`.audio`), and image preprocessing and
the image data modules (:mod:`.vision`)."""
from perceiver_io_tpu_torch.data.loader import DataLoader, default_collate

__all__ = ["DataLoader", "default_collate"]

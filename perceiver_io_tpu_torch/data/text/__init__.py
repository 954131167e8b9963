"""Text data pipelines of the port (counterpart of ``perceiver_io_tpu/data/text``;
reference ``perceiver/data/text/``, SURVEY.md §2.3)."""
from perceiver_io_tpu_torch.data.text.collators import (
    DefaultCollator,
    RandomTruncateCollator,
    TokenMaskingCollator,
    WordMaskingCollator,
)
from perceiver_io_tpu_torch.data.text.datamodule import (
    ChunkedTokenDataset,
    CLMView,
    RandomShiftView,
    Task,
    TextDataModule,
)
from perceiver_io_tpu_torch.data.text.preprocessor import TextPreprocessor
from perceiver_io_tpu_torch.data.text.streaming import (
    C4DataModule,
    StreamingTextPipeline,
    shard_iterable,
    window_shuffle,
)
from perceiver_io_tpu_torch.data.text.sources import (
    BookCorpusDataModule,
    Enwik8DataModule,
    ImdbDataModule,
    ListDataModule,
    WikipediaDataModule,
    WikiTextDataModule,
)
from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer, HFTokenizer, load_tokenizer

__all__ = [
    "ByteTokenizer",
    "BookCorpusDataModule",
    "C4DataModule",
    "StreamingTextPipeline",
    "shard_iterable",
    "window_shuffle",
    "CLMView",
    "ChunkedTokenDataset",
    "DefaultCollator",
    "Enwik8DataModule",
    "HFTokenizer",
    "ImdbDataModule",
    "ListDataModule",
    "RandomShiftView",
    "RandomTruncateCollator",
    "Task",
    "TextDataModule",
    "TextPreprocessor",
    "TokenMaskingCollator",
    "WikiTextDataModule",
    "WikipediaDataModule",
    "WordMaskingCollator",
    "load_tokenizer",
]

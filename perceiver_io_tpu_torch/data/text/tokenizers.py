"""Tokenizers behind one small protocol. A copy of
``perceiver_io_tpu/data/text/tokenizers.py``:

- :class:`ByteTokenizer` is the offline byte vocabulary of
  ``deepmind/language-perceiver`` (262 = 6 specials + 256 bytes, offset 6,
  the layout of ``transformers.PerceiverTokenizer``), so byte-level models
  need no hub access;
- :class:`HFTokenizer` adapts any Hugging Face tokenizer to the same
  protocol (e.g. the SentencePiece tokenizer of the C4 models);
- :func:`load_tokenizer` resolves a name to one of the two, and imports
  ``transformers`` only for a name that is not the byte tokenizer's.

The protocol its consumers rely on: ``encode``, ``decode``,
``encode_batch``, ``word_ids``, and the ``vocab_size`` / ``pad_token_id`` /
``mask_token_id`` / ``eos_token_id`` / ``padding_side`` attributes.
"""
from __future__ import annotations

import string
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Byte-tokenizer special tokens — the PerceiverTokenizer layout.
PAD_ID, BOS_ID, EOS_ID, MASK_ID, CLS_ID, SEP_ID = range(6)
BYTE_OFFSET = 6
BYTE_VOCAB_SIZE = 262


class ByteTokenizer:
    """UTF-8 bytes tokenizer: token = byte + 6; ids 0..5 are
    [PAD] [BOS] [EOS] [MASK] [CLS] [SEP]. Word boundaries (for whole-word
    masking) are whitespace runs, synthesised like the reference's
    ``PerceiverTokenizerUtil`` (``perceiver/data/text/utils.py:13-39``)."""

    vocab_size = BYTE_VOCAB_SIZE
    pad_token_id = PAD_ID
    bos_token_id = BOS_ID
    eos_token_id = EOS_ID
    mask_token_id = MASK_ID
    cls_token_id = CLS_ID
    sep_token_id = SEP_ID
    mask_token = "<mask>"  # placeholder substring, mapped to MASK_ID in encode
    name = "byte"

    _WHITESPACE_IDS = frozenset(b + BYTE_OFFSET for b in string.whitespace.encode())

    def __init__(self, padding_side: str = "right"):
        self.padding_side = padding_side

    # -- encode / decode ----------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        for i, part in enumerate(text.split(self.mask_token)):
            if i > 0:
                ids.append(MASK_ID)
            # vectorized byte mapping: the corpus-preproc hot loop
            ids.extend(
                (np.frombuffer(part.encode("utf-8"), np.uint8).astype(np.int64) + BYTE_OFFSET).tolist()
            )
        if add_special_tokens:
            ids = [CLS_ID] + ids + [SEP_ID]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i >= BYTE_OFFSET:
                out.append(i - BYTE_OFFSET)
            elif not skip_special_tokens:
                out += f"[{i}]".encode()
        return out.decode("utf-8", errors="replace")

    def batch_decode(self, rows, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(r, skip_special_tokens) for r in rows]

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        add_special_tokens: bool = False,
        pad_to_max: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(input_ids, pad_mask)`` with pad_mask True at padding —
        the reference's inverted-attention-mask convention
        (``perceiver/data/text/common.py:35-46``)."""
        seqs = [self.encode(t, add_special_tokens) for t in texts]
        if max_length is not None:
            seqs = [
                s[:max_length] if len(s) <= max_length or not add_special_tokens
                # keep the trailing [SEP] when truncating a special-tokens encode
                else s[: max_length - 1] + [SEP_ID]
                for s in seqs
            ]
        width = max(len(s) for s in seqs) if seqs else 0
        if pad_to_max and max_length is not None:
            width = max_length
        ids = np.full((len(seqs), width), self.pad_token_id, dtype=np.int32)
        mask = np.ones((len(seqs), width), dtype=bool)
        for row, s in enumerate(seqs):
            n = len(s)
            if self.padding_side == "left":
                ids[row, width - n :] = s
                mask[row, width - n :] = False
            else:
                ids[row, :n] = s
                mask[row, :n] = False
        return ids, mask

    # -- word ids for whole-word masking ------------------------------------
    def word_ids(self, token_ids: Sequence[int]) -> List[Optional[int]]:
        """Whitespace-boundary word ids; whitespaces join the *following* word;
        special tokens get ``None`` (reference ``utils.py:13-39`` semantics:
        distinct words ⇒ distinct ids)."""
        out: List[Optional[int]] = []
        curr = 0
        in_word = True
        for t in token_ids:
            t = int(t)
            if t < BYTE_OFFSET:
                out.append(None)
                curr += 1
            elif t in self._WHITESPACE_IDS:
                if in_word:
                    in_word = False
                    curr += 1
                out.append(curr)
            else:
                in_word = True
                out.append(curr)
        return out


class HFTokenizer:
    """Adapter: any Hugging Face (fast) tokenizer → the local protocol."""

    def __init__(self, tokenizer, padding_side: Optional[str] = None):
        self.hf = tokenizer
        if padding_side is not None:
            self.hf.padding_side = padding_side
        self.name = getattr(tokenizer, "name_or_path", "hf")

    @property
    def padding_side(self) -> str:
        return self.hf.padding_side

    @padding_side.setter
    def padding_side(self, side: str) -> None:
        self.hf.padding_side = side

    @property
    def vocab_size(self) -> int:
        return self.hf.vocab_size

    @property
    def pad_token_id(self):
        return self.hf.pad_token_id

    @property
    def mask_token_id(self):
        return self.hf.mask_token_id

    @property
    def mask_token(self):
        return self.hf.mask_token

    @property
    def eos_token_id(self):
        return self.hf.eos_token_id

    def batch_decode(self, rows, skip_special_tokens: bool = True) -> List[str]:
        return self.hf.batch_decode(
            [[int(i) for i in r] for r in rows], skip_special_tokens=skip_special_tokens
        )

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self.hf(text, add_special_tokens=add_special_tokens)["input_ids"]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.hf.decode([int(i) for i in ids], skip_special_tokens=skip_special_tokens)

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        add_special_tokens: bool = False,
        pad_to_max: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.hf(
            list(texts),
            padding="max_length" if (pad_to_max and max_length) else bool(self.hf.pad_token),
            truncation=max_length is not None,
            max_length=max_length,
            add_special_tokens=add_special_tokens,
            return_attention_mask=True,
        )
        ids = np.asarray(enc["input_ids"], dtype=np.int32)
        pad_mask = ~np.asarray(enc["attention_mask"], dtype=bool)
        return ids, pad_mask

    def word_ids(self, token_ids: Sequence[int]) -> List[Optional[int]]:
        # Fast tokenizers expose word ids only at encode time; re-derive from a
        # round-trip is lossy, so synthesize whitespace-boundary ids from the
        # decoded pieces (sufficient for WordMaskingCollator: distinct words
        # get distinct ids).
        out: List[Optional[int]] = []
        special = set(self.hf.all_special_ids)
        curr = 0
        in_word = True
        for t in token_ids:
            t = int(t)
            if t in special:
                out.append(None)
                curr += 1
                continue
            piece = self.hf.convert_ids_to_tokens(t)
            starts_word = piece.startswith(("Ġ", "▁", " ")) or piece.isspace()
            if starts_word and in_word:
                curr += 1
            in_word = not (starts_word and piece.isspace())
            out.append(curr)
        return out


def load_tokenizer(name: str, padding_side: Optional[str] = None):
    """Resolve a tokenizer name. ``"byte"`` / the two Perceiver byte-tokenizer
    repo ids map to the offline :class:`ByteTokenizer`; anything else goes
    through ``AutoTokenizer`` (reference ``common.py:116-126``)."""
    if name in ("byte", "deepmind/language-perceiver", "krasserm/perceiver-io-mlm"):
        return ByteTokenizer(padding_side=padding_side or "right")
    from transformers import AutoTokenizer

    return HFTokenizer(AutoTokenizer.from_pretrained(name, verbose=False), padding_side)

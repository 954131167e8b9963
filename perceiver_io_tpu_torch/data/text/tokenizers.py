"""The offline UTF-8 byte tokenizer. A copy of ``ByteTokenizer`` from
``perceiver_io_tpu/data/text/tokenizers.py``: the byte vocabulary of
``deepmind/language-perceiver`` (262 = 6 specials + 256 bytes, offset 6,
the layout of ``transformers.PerceiverTokenizer``), so byte-level models need
no hub access. The hub adapter (``HFTokenizer``, ``load_tokenizer``) is not
ported: no hub tokenizer is in the repo.

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

"""Position encodings: shifted absolute positions and rotary embeddings.

Counterpart of ``perceiver_io_tpu/ops/position.py``. The N-D Fourier
encoding belongs to the encoder families and is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def positions(b: int, n: int, shift: Optional[torch.Tensor] = None, *,
              device=None) -> torch.Tensor:
    """Absolute positions ``0..n-1`` per batch row, shifted left by a per-row
    pad count (left-padded batches) and clamped at 0.

    :param shift: optional ``(b, 1)`` integer tensor, the left-pad counts.
    :return: ``(b, n)`` int64 positions.
    """
    if shift is not None:
        device = shift.device
    pos = torch.arange(n, device=device).expand(b, n)
    if shift is not None:
        if tuple(shift.shape) != (b, 1):
            raise ValueError(f"shift must have shape {(b, 1)} but has shape {tuple(shift.shape)}")
        pos = pos - shift.long()
    return pos.clamp(min=0)


def frequency_position_encoding(abs_pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Rotary angles ``pos * inv_freq`` in fp32, each frequency repeated
    twice along the channel axis (``[f0, f0, f1, f1, ...]``), the pairing
    :func:`rotate_half` consumes.

    :param abs_pos: ``(..., n)`` integer positions.
    :return: ``(..., n, dim)`` float32 angles.
    """
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=abs_pos.device) / dim
    inv_freq = 1.0 / (10000 ** exponent)
    pos_enc = abs_pos.to(torch.float32)[..., None] * inv_freq
    return pos_enc.repeat_interleave(2, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Channel-pair rotation ``[x1, x2, x3, x4, ...] -> [-x2, x1, -x4, x3, ...]``
    (pairwise, not a half split)."""
    x = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


@dataclass
class RotaryEmbedding:
    """Rotary embedding of the leading ``rotate_dim`` channels of q/k heads;
    the other channels pass through. ``frq_pos_enc`` is ``(b, n, rotate_dim)``.
    With ``right_align`` a shorter input of length ``m < n`` takes the last
    ``m`` positions (Perceiver AR's latents sit at the sequence tail)."""

    frq_pos_enc: torch.Tensor
    right_align: bool = False

    @property
    def rotate_dim(self) -> int:
        return self.frq_pos_enc.shape[-1]

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        """Rotate ``t`` of shape ``(b, h, m, c)`` with ``c >= rotate_dim``,
        in fp32, casting the rotated channels back to ``t``'s type."""
        seq_len = t.shape[-2]
        pos_enc = self.frq_pos_enc[:, None, :, :]
        if self.right_align:
            pos_enc = pos_enc[..., pos_enc.shape[-2] - seq_len:, :]
        else:
            pos_enc = pos_enc[..., :seq_len, :]
        pos_enc = pos_enc.to(torch.float32)
        rd = self.rotate_dim
        t_rot, t_pass = t[..., :rd], t[..., rd:]
        t_rot32 = t_rot.to(torch.float32)
        t_rot32 = t_rot32 * torch.cos(pos_enc) + rotate_half(t_rot32) * torch.sin(pos_enc)
        return torch.cat((t_rot32.to(t.dtype), t_pass), dim=-1)

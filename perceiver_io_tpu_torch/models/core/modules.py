"""Perceiver AR runtime modules for inference, as ``nn.Module``s.

Counterpart of ``perceiver_io_tpu/models/core/modules.py``. Submodule names
are the flax names (``q_proj``, ``q_norm``, ``layers.0`` for ``layers_0``,
...), so :mod:`perceiver_io_tpu_torch.convert.from_jax` maps a JAX param tree
onto a ``state_dict`` one to one.

Dtype policy as in the JAX package: parameters are fp32 and ``dtype`` is the
computation type: linear layers cast input and weight to it, layer norms
take their statistics in fp32 and return ``dtype``.

Train mode (``deterministic=False``) is ported for Perceiver AR with its
prefix (cross-attention) dropout; attention and residual dropout, remat,
offloading and the fused-QKV switch are not (they raise). The Perceiver IO
encoder/decoder come with their families.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_tpu_torch.ops.attention import dot_product_attention
from perceiver_io_tpu_torch.ops.position import RotaryEmbedding, positions

# torch defaults, required for numerical parity with the reference.
LAYER_NORM_EPS = 1e-5


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``Dense(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``norm(x)`` with fp32 statistics, returned in ``dtype``."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(dtype)


def _layer_norm(num_channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(num_channels, eps=LAYER_NORM_EPS)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with optional rotary embeddings and right-aligned
    causal attention. ``project_q`` / ``project_kv`` / ``project_out`` /
    ``attend`` are the seams the KV-cache decode phases call."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 max_heads_parallel: Optional[int] = None, causal_attention: bool = False,
                 qkv_bias: bool = True, out_bias: bool = True,
                 dtype: torch.dtype = torch.float32, attention_impl: str = "auto"):
        super().__init__()
        # q/k/v widths are the query width, as in every Perceiver AR layer
        qk = v = out = num_q_input_channels
        if qk % num_heads != 0:
            raise ValueError("num_q_input_channels must be divisible by num_heads")
        self.num_heads = num_heads
        self.num_qk_channels = qk
        self.max_heads_parallel = max_heads_parallel
        self.causal_attention = causal_attention
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.q_proj = nn.Linear(num_q_input_channels, qk, bias=qkv_bias)
        self.k_proj = nn.Linear(num_kv_input_channels, qk, bias=qkv_bias)
        self.v_proj = nn.Linear(num_kv_input_channels, v, bias=qkv_bias)
        self.o_proj = nn.Linear(v, out, bias=out_bias)

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.reshape(b, n, self.num_heads, -1).transpose(1, 2)

    def _merge_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, h, n, c = x.shape
        return x.transpose(1, 2).reshape(b, n, h * c)

    def project_q(self, x_q: torch.Tensor, rot_pos_emb: Optional[RotaryEmbedding] = None) -> torch.Tensor:
        """``(b, n, Dq)`` -> scaled, then rotated ``(b, h, n, ck)``."""
        q = self._split_heads(dense(self.q_proj, x_q, self.dtype))
        q = q * ((self.num_qk_channels // self.num_heads) ** -0.5)
        if rot_pos_emb is not None:
            q = rot_pos_emb.rotate(q)
        return q

    def project_kv(self, x_kv: torch.Tensor, rot_pos_emb: Optional[RotaryEmbedding] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(b, n, Dkv)`` -> rotated keys ``(b, h, n, ck)``, values ``(b, h, n, cv)``."""
        k = self._split_heads(dense(self.k_proj, x_kv, self.dtype))
        if rot_pos_emb is not None:
            k = rot_pos_emb.rotate(k)
        v = self._split_heads(dense(self.v_proj, x_kv, self.dtype))
        return k, v

    def project_out(self, o: torch.Tensor) -> torch.Tensor:
        """``(b, h, n, cv)`` -> merged and output-projected ``(b, n, out)``."""
        return dense(self.o_proj, self._merge_heads(o), self.dtype)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention and output projection over projected heads."""
        o = dot_product_attention(
            q, k, v, pad_mask=pad_mask, causal=self.causal_attention,
            max_heads_parallel=self.max_heads_parallel, impl=self.attention_impl,
        )
        return self.project_out(o)

    def forward(self, x_q, x_kv, pad_mask=None, rot_pos_emb_q=None, rot_pos_emb_k=None):
        q = self.project_q(x_q, rot_pos_emb_q)
        k, v = self.project_kv(x_kv, rot_pos_emb_k)
        return self.attend(q, k, v, pad_mask=pad_mask)


class CrossAttention(nn.Module):
    """Pre-layer-norm cross-attention with the Perceiver AR ``x_kv_prefix``
    path: keys/values are ``[kv_norm(prefix) || q_norm(x_q)]``."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 dtype: torch.dtype = torch.float32, **attention_kwargs):
        super().__init__()
        self.dtype = dtype
        self.q_norm = _layer_norm(num_q_input_channels)
        self.kv_norm = _layer_norm(num_kv_input_channels)
        self.attention = MultiHeadAttention(
            num_heads, num_q_input_channels, num_kv_input_channels, dtype=dtype,
            **attention_kwargs,
        )

    def forward(self, x_q, x_kv=None, x_kv_prefix=None, pad_mask=None,
                rot_pos_emb_q=None, rot_pos_emb_k=None):
        x_q = layer_norm(self.q_norm, x_q, self.dtype)
        if x_kv is None:
            x_kv_prefix = layer_norm(self.kv_norm, x_kv_prefix, self.dtype)
            x_kv = torch.cat([x_kv_prefix, x_q], dim=1)
        else:
            x_kv = layer_norm(self.kv_norm, x_kv, self.dtype)
        return self.attention(x_q, x_kv, pad_mask, rot_pos_emb_q, rot_pos_emb_k)


class SelfAttention(nn.Module):
    """Pre-layer-norm self-attention."""

    def __init__(self, num_heads: int, num_channels: int, dtype: torch.dtype = torch.float32,
                 **attention_kwargs):
        super().__init__()
        self.dtype = dtype
        self.norm = _layer_norm(num_channels)
        self.attention = MultiHeadAttention(
            num_heads, num_channels, num_channels, dtype=dtype, **attention_kwargs
        )

    def forward(self, x, pad_mask=None, rot_pos_emb=None):
        x = layer_norm(self.norm, x, self.dtype)
        return self.attention(x, x, pad_mask, rot_pos_emb, rot_pos_emb)


class MLP(nn.Module):
    """LayerNorm -> Linear(widening * ch) -> GELU (exact) -> Linear(ch)."""

    def __init__(self, num_channels: int, widening_factor: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = _layer_norm(num_channels)
        self.hidden = nn.Linear(num_channels, widening_factor * num_channels, bias=bias)
        self.out = nn.Linear(widening_factor * num_channels, num_channels, bias=bias)

    def forward(self, x):
        x = layer_norm(self.norm, x, self.dtype)
        x = F.gelu(dense(self.hidden, x, self.dtype), approximate="none")
        return dense(self.out, x, self.dtype)


class CrossAttentionLayer(nn.Module):
    """Residual cross-attention, then residual MLP."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 widening_factor: int = 1, mlp_bias: bool = True,
                 dtype: torch.dtype = torch.float32, **attention_kwargs):
        super().__init__()
        self.cross_attn = CrossAttention(
            num_heads, num_q_input_channels, num_kv_input_channels, dtype=dtype,
            **attention_kwargs,
        )
        self.mlp = MLP(num_q_input_channels, widening_factor, bias=mlp_bias, dtype=dtype)

    def forward(self, x_q, x_kv=None, x_kv_prefix=None, pad_mask=None,
                rot_pos_emb_q=None, rot_pos_emb_k=None):
        x = self.cross_attn(x_q, x_kv, x_kv_prefix, pad_mask, rot_pos_emb_q, rot_pos_emb_k) + x_q
        return self.mlp(x) + x


class SelfAttentionLayer(nn.Module):
    """Residual self-attention, then residual MLP."""

    def __init__(self, num_heads: int, num_channels: int, widening_factor: int = 1,
                 mlp_bias: bool = True, dtype: torch.dtype = torch.float32,
                 **attention_kwargs):
        super().__init__()
        self.self_attn = SelfAttention(num_heads, num_channels, dtype=dtype, **attention_kwargs)
        self.mlp = MLP(num_channels, widening_factor, bias=mlp_bias, dtype=dtype)

    def forward(self, x, pad_mask=None, rot_pos_emb=None):
        x = self.self_attn(x, pad_mask, rot_pos_emb) + x
        return self.mlp(x) + x


class SelfAttentionBlock(nn.Module):
    """Stack of self-attention layers. Rotary embeddings reach only the first
    layer, the reference behaviour Perceiver AR checkpoints are trained with
    (the JAX ``rotary_all_layers=False``); ``pad_mask`` reaches every layer."""

    def __init__(self, num_layers: int, num_heads: int, num_channels: int,
                 widening_factor: int = 1, mlp_bias: bool = True,
                 dtype: torch.dtype = torch.float32, **attention_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(
            SelfAttentionLayer(num_heads, num_channels, widening_factor, mlp_bias=mlp_bias,
                               dtype=dtype, **attention_kwargs)
            for _ in range(num_layers)
        )

    def forward(self, x, pad_mask=None, rot_pos_emb=None):
        for i, layer in enumerate(self.layers):
            x = layer(x, pad_mask, rot_pos_emb if i == 0 else None)
        return x


def prefix_noise(b: int, prefix_len: int, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """Uniform ``(b, prefix_len)`` scores of prefix dropout (JAX
    ``jax.random.uniform(make_rng("prefix"), (b, prefix_len))``). The one
    seam of the draw: a test replaces it to feed both packages the same
    noise."""
    return torch.rand(b, prefix_len, generator=generator, device=device)


def prefix_keep_indices(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """``(b, keep)`` prefix positions kept by prefix dropout: the ``keep``
    highest scores of each row (JAX ``lax.top_k``), in sequence order."""
    return torch.sort(torch.topk(scores, keep, dim=1).indices, dim=1).values


class PerceiverAR(nn.Module):
    """Perceiver AR: causal cross-attention of the latents (the sequence
    tail) over ``[prefix || latents]``, then a causal self-attention stack
    over the latents, with rotary position embeddings.

    ``input_adapter`` maps ``(token_ids, abs_pos)`` to
    ``(x_embedded, frq_pos_enc)``. In train mode (``deterministic=False``)
    prefix dropout keeps a static ``keep = prefix_len - int(prefix_len *
    cross_attention_dropout)`` prefix positions per row, chosen by ``topk``
    over uniform scores (:func:`prefix_noise`) with the indices sorted to
    keep sequence order, as the JAX package does.

    Not ported: attention dropout (``post_attention_dropout``) and residual
    dropout in train mode, activation checkpointing and offloading; they
    raise ``NotImplementedError``.
    """

    def __init__(self, input_adapter: nn.Module, num_heads: int = 8,
                 max_heads_parallel: Optional[int] = None, num_self_attention_layers: int = 6,
                 self_attention_widening_factor: int = 4,
                 cross_attention_widening_factor: int = 4,
                 cross_attention_dropout: float = 0.5, post_attention_dropout: float = 0.0,
                 residual_dropout: float = 0.0, activation_checkpointing: bool = False,
                 activation_offloading: bool = False,
                 dtype: torch.dtype = torch.float32, attention_impl: str = "auto"):
        super().__init__()
        if activation_checkpointing or activation_offloading:
            raise NotImplementedError(
                "activation checkpointing and offloading are not ported yet (ROADMAP.md A)"
            )
        num_channels = input_adapter.num_input_channels
        self.cross_attention_dropout = cross_attention_dropout
        self.post_attention_dropout = post_attention_dropout
        self.residual_dropout = residual_dropout
        self.input_adapter = input_adapter
        attn = dict(max_heads_parallel=max_heads_parallel, causal_attention=True,
                    qkv_bias=False, attention_impl=attention_impl)
        self.cross_attention = CrossAttentionLayer(
            num_heads, num_channels, num_channels,
            widening_factor=cross_attention_widening_factor, mlp_bias=False, dtype=dtype,
            out_bias=True, **attn,
        )
        self.self_attention = SelfAttentionBlock(
            num_self_attention_layers, num_heads, num_channels,
            widening_factor=self_attention_widening_factor, mlp_bias=False, dtype=dtype,
            out_bias=False, **attn,
        )

    def forward(self, x: torch.Tensor, prefix_len: int,
                pad_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n = x.shape
        if not 0 <= prefix_len < n:
            raise ValueError(f"prefix_len ({prefix_len}) out of valid range [0..{n})")
        if not deterministic and (self.post_attention_dropout > 0.0 or self.residual_dropout > 0.0):
            raise NotImplementedError(
                "attention and residual dropout are not ported yet (ROADMAP.md A); "
                "set post_attention_dropout and residual_dropout to 0"
            )
        # the caller left-pads x
        shift = None if pad_mask is None else pad_mask.sum(dim=1, keepdim=True)
        x, frq = self.input_adapter(x, abs_pos=positions(b, n, shift=shift, device=x.device))

        x_latent, x_prefix = x[:, prefix_len:], x[:, :prefix_len]
        frq_latent, frq_prefix = frq[:, prefix_len:], frq[:, :prefix_len]
        pad_latent = None if pad_mask is None else pad_mask[:, prefix_len:]
        pad_prefix = None if pad_mask is None else pad_mask[:, :prefix_len]
        if not deterministic and prefix_len > 0 and self.cross_attention_dropout > 0.0:
            keep = prefix_len - int(prefix_len * self.cross_attention_dropout)
            idx = prefix_keep_indices(prefix_noise(b, prefix_len, generator, x.device), keep)
            x_prefix = torch.gather(x_prefix, 1, idx[..., None].expand(-1, -1, x_prefix.shape[-1]))
            frq_prefix = torch.gather(frq_prefix, 1, idx[..., None].expand(-1, -1, frq_prefix.shape[-1]))
            if pad_prefix is not None:
                pad_prefix = torch.gather(pad_prefix, 1, idx)
        if pad_mask is not None:
            pad_mask = torch.cat([pad_prefix, pad_latent], dim=1)

        x_latent = self.cross_attention(
            x_latent, None, x_prefix, pad_mask,
            RotaryEmbedding(frq_latent, right_align=True),
            RotaryEmbedding(torch.cat([frq_prefix, frq_latent], dim=1), right_align=True),
        )
        # Neither package masks the stack (JAX modules.py:1000-1005): a
        # latent whose cross-attention row saw no key is a key here. The
        # flash kernel gives that row 0, the einsum path a uniform average,
        # so with pads reaching into the latents the two differ on live rows.
        return self.self_attention(x_latent, None, RotaryEmbedding(frq_latent, right_align=True))


def init_weights(module: nn.Module, init_scale: float, generator: torch.Generator) -> None:
    """The JAX package's initialisers: normal(``init_scale``) for linear and
    embedding weights, zeros for biases, ones/zeros for layer norms."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, init_scale, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, init_scale, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


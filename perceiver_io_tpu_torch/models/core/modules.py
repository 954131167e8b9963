"""Perceiver runtime modules (Perceiver IO encoder/decoder, Perceiver AR),
as ``nn.Module``s.

Counterpart of ``perceiver_io_tpu/models/core/modules.py``. Submodule names
are the flax names (``q_proj``, ``q_norm``, ``layers.0`` for ``layers_0``,
...), so :mod:`perceiver_io_tpu_torch.convert.from_jax` maps a JAX param tree
onto a ``state_dict`` one to one.

Dtype policy as in the JAX package: parameters are fp32 and ``dtype`` is the
computation type: linear layers cast input and weight to it, layer norms
take their statistics in fp32 and return ``dtype``.

Train mode (``deterministic=False``) is ported for Perceiver AR: prefix
(cross-attention) dropout, attention dropout (``post_attention_dropout``)
and residual dropout, each drawn from the step's ``torch.Generator`` in
forward order: the prefix scores first, then per layer the attention
keep-masks, the attention branch's and the MLP branch's. Activation
checkpointing recomputes each layer in the backward
(``torch.utils.checkpoint``) and, with offloading, keeps only the layers'
inputs, in pinned host memory. The fused-QKV switch is not ported.

The Perceiver IO encoder and decoder (:class:`PerceiverEncoder`,
:class:`PerceiverDecoder`, :class:`PerceiverIO`) keep JAX's weight sharing:
``cross_attn_1`` / ``self_attn_1`` are applied again at later depths
unless an unshared ``cross_attn_n`` / ``self_attn_n`` is configured, so one
parameter set appears once in the ``state_dict``. Their attention layers
take q/k and v channels apart (``num_qk_channels``, ``num_v_channels``),
and the decoder's cross-attention may drop its attention residual (the
masked LM's ``cross_attention_residual=False``).

Tensor parallelism: the parallel runtime gives a layer that runs
tensor-parallel a ``tp`` (:class:`~perceiver_io_tpu_torch.parallel.collectives.TensorParallel`)
and hands it its shard of the weights (``parallel/partition.py``). An
attention then holds ``num_heads / tp.size`` heads: q/k/v column-parallel
into them, o row-parallel out of them with the all-reduce before its bias;
an MLP holds ``1 / tp.size`` of its hidden width the same way. Without
``tp`` (the default) nothing changes.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from perceiver_io_tpu_torch.models.core.adapter import TrainableQueryProvider
from perceiver_io_tpu_torch.ops.attention import dot_product_attention, draw_shape, draw_view, dropout
from perceiver_io_tpu_torch.ops.position import RotaryEmbedding, positions

# torch defaults, required for numerical parity with the reference.
LAYER_NORM_EPS = 1e-5


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``Dense(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp) -> torch.Tensor:
    """A row-parallel ``dense``: this rank's share of the product, summed
    over the tensor-parallel group, then the (replicated) bias."""
    y = tp.reduce(F.linear(x.to(dtype), layer.weight.to(dtype)))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``norm(x)`` with fp32 statistics and fp32 scale and bias (weights
    stored in bf16 are widened, as flax promotes them), returned in
    ``dtype``."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return y.to(dtype)


def _layer_norm(num_channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(num_channels, eps=LAYER_NORM_EPS)


#: what the offloading pack hook handed to the host since the last reset:
#: saved layer inputs and their bytes (CPU tensors stay where they are)
offload_counts = {"tensors": 0, "bytes": 0}


def reset_offload_counts() -> None:
    offload_counts.update(tensors=0, bytes=0)


def _offload_pack(t: torch.Tensor):
    if t.numel() == 0:  # the empty placeholder some torch versions' checkpoint saves
        return None, t
    offload_counts["tensors"] += 1
    offload_counts["bytes"] += t.numel() * t.element_size()
    if t.device.type == "cpu":
        return None, t
    host = torch.empty(t.size(), dtype=t.dtype, layout=t.layout, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return t.device, host


def _offload_unpack(packed) -> torch.Tensor:
    device, t = packed
    return t if device is None else t.to(device, non_blocking=True)


def remat(layer: nn.Module, args: tuple, *, deterministic: bool,
          generator: Optional[torch.Generator], enabled: bool = True,
          offload: bool = False) -> torch.Tensor:
    """``layer(*args, deterministic=..., generator=...)`` under activation
    checkpointing (JAX ``nn.remat`` of the layer): nothing inside the layer
    is saved for the backward, which runs its forward again. Without
    ``enabled``, or while gradients are off, it is the plain call.

    ``torch.utils.checkpoint`` replays only the global RNGs, so the layer's
    dropout masks would differ in the recompute. Here the generator's state
    is taken before the layer (a host-side copy, no device sync) and set
    again for the recompute, then put back, so the recompute draws the same
    masks and leaves the generator where the backward found it.

    With ``offload`` the checkpoint's saved inputs (the layer inputs, JAX's
    ``remat_layer_input``) go to pinned host memory through a saved-tensor
    hook (:data:`offload_counts` counts them) and come back in the backward.
    """
    if not (enabled and torch.is_grad_enabled()):
        return layer(*args, deterministic=deterministic, generator=generator)
    start = None if generator is None else generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or start is None:
            return layer(*a, deterministic=deterministic, generator=generator)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*a, deterministic=deterministic, generator=generator)
        finally:
            generator.set_state(resume)

    hooks = (torch.autograd.graph.saved_tensors_hooks(_offload_pack, _offload_unpack)
             if offload else contextlib.nullcontext())
    with hooks:
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=generator is None and not deterministic)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with optional rotary embeddings and right-aligned
    causal attention. ``project_q`` / ``project_kv`` / ``project_out`` /
    ``attend`` are the seams the KV-cache decode phases call. With ``tp``
    set it runs on its share of the heads (module docstring).

    q/k channels default to the query width and v channels to the q/k ones
    (JAX ``MultiHeadAttention._channels``); the output has the query width.
    """

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 num_qk_channels: Optional[int] = None, num_v_channels: Optional[int] = None,
                 max_heads_parallel: Optional[int] = None, causal_attention: bool = False,
                 qkv_bias: bool = True, out_bias: bool = True, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, attention_impl: str = "auto"):
        super().__init__()
        qk = num_qk_channels or num_q_input_channels
        v = num_v_channels or qk
        out = num_q_input_channels
        if qk % num_heads != 0:
            raise ValueError("num_qk_channels must be divisible by num_heads")
        if v % num_heads != 0:
            raise ValueError("num_v_channels must be divisible by num_heads")
        self.num_heads = num_heads
        self.num_qk_channels = qk
        self.max_heads_parallel = max_heads_parallel
        self.causal_attention = causal_attention
        self.dropout = dropout
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.q_proj = nn.Linear(num_q_input_channels, qk, bias=qkv_bias)
        self.k_proj = nn.Linear(num_kv_input_channels, qk, bias=qkv_bias)
        self.v_proj = nn.Linear(num_kv_input_channels, v, bias=qkv_bias)
        self.o_proj = nn.Linear(v, out, bias=out_bias)
        #: the tensor-parallel group when this layer runs on a share of its heads
        self.tp = None

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        heads = self.num_heads if self.tp is None else self.tp.local(self.num_heads)
        return x.reshape(b, n, heads, -1).transpose(1, 2)

    def _merge_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, h, n, c = x.shape
        return x.transpose(1, 2).reshape(b, n, h * c)

    def project_q(self, x_q: torch.Tensor, rot_pos_emb: Optional[RotaryEmbedding] = None) -> torch.Tensor:
        """``(b, n, Dq)`` -> scaled, then rotated ``(b, h, n, ck)``."""
        if self.tp is not None:
            x_q = self.tp.enter(x_q)
        q = self._split_heads(dense(self.q_proj, x_q, self.dtype))
        q = q * ((self.num_qk_channels // self.num_heads) ** -0.5)
        if rot_pos_emb is not None:
            q = rot_pos_emb.rotate(q)
        return q

    def project_kv(self, x_kv: torch.Tensor, rot_pos_emb: Optional[RotaryEmbedding] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(b, n, Dkv)`` -> rotated keys ``(b, h, n, ck)``, values ``(b, h, n, cv)``."""
        if self.tp is not None:
            x_kv = self.tp.enter(x_kv)
        k = self._split_heads(dense(self.k_proj, x_kv, self.dtype))
        if rot_pos_emb is not None:
            k = rot_pos_emb.rotate(k)
        v = self._split_heads(dense(self.v_proj, x_kv, self.dtype))
        return k, v

    def project_out(self, o: torch.Tensor) -> torch.Tensor:
        """``(b, h, n, cv)`` -> merged and output-projected ``(b, n, out)``."""
        if self.tp is None:
            return dense(self.o_proj, self._merge_heads(o), self.dtype)
        return row_parallel(self.o_proj, self._merge_heads(o), self.dtype, self.tp)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pad_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Attention and output projection over projected heads; in train
        mode with ``dropout > 0`` the plain path with attention dropout
        (under ``tp`` drawn over every head, this rank's kept)."""
        heads = contextlib.nullcontext()
        if self.tp is not None:
            local = self.tp.local(self.num_heads)
            heads = draw_view(1, self.tp.rank * local, self.num_heads)
        with heads:
            o = dot_product_attention(
                q, k, v, pad_mask=pad_mask, causal=self.causal_attention,
                dropout_rate=0.0 if deterministic else self.dropout, generator=generator,
                max_heads_parallel=self.max_heads_parallel, impl=self.attention_impl,
            )
        return self.project_out(o)

    def forward(self, x_q, x_kv, pad_mask=None, rot_pos_emb_q=None, rot_pos_emb_k=None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        q = self.project_q(x_q, rot_pos_emb_q)
        k, v = self.project_kv(x_kv, rot_pos_emb_k)
        return self.attend(q, k, v, pad_mask=pad_mask, deterministic=deterministic,
                           generator=generator)


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
                rot_pos_emb_q=None, rot_pos_emb_k=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x_q = layer_norm(self.q_norm, x_q, self.dtype)
        if x_kv is None:
            x_kv_prefix = layer_norm(self.kv_norm, x_kv_prefix, self.dtype)
            x_kv = torch.cat([x_kv_prefix, x_q], dim=1)
        else:
            x_kv = layer_norm(self.kv_norm, x_kv, self.dtype)
        return self.attention(x_q, x_kv, pad_mask, rot_pos_emb_q, rot_pos_emb_k,
                              deterministic, generator)


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

    def forward(self, x, pad_mask=None, rot_pos_emb=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = layer_norm(self.norm, x, self.dtype)
        return self.attention(x, x, pad_mask, rot_pos_emb, rot_pos_emb, deterministic, generator)


class MLP(nn.Module):
    """LayerNorm -> Linear(widening * ch) -> GELU (exact) -> Linear(ch).
    With ``tp`` set it holds a share of the hidden width (module
    docstring)."""

    def __init__(self, num_channels: int, widening_factor: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = _layer_norm(num_channels)
        self.hidden = nn.Linear(num_channels, widening_factor * num_channels, bias=bias)
        self.out = nn.Linear(widening_factor * num_channels, num_channels, bias=bias)
        #: the tensor-parallel group when this layer runs on a share of its width
        self.tp = None

    def forward(self, x):
        x = layer_norm(self.norm, x, self.dtype)
        if self.tp is not None:
            x = self.tp.enter(x)
        x = F.gelu(dense(self.hidden, x, self.dtype), approximate="none")
        if self.tp is not None:
            return row_parallel(self.out, x, self.dtype, self.tp)
        return dense(self.out, x, self.dtype)


class _ResidualDropout(nn.Module):
    """Dropout on the residual branch before the add (JAX
    ``_ResidualDropout``); no parameters."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, branch: torch.Tensor, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return (branch if deterministic else dropout(branch, self.rate, generator)) + x


class CrossAttentionLayer(nn.Module):
    """Residual cross-attention, then residual MLP, each branch through
    residual dropout. Without ``attention_residual`` (the masked LM's
    decoder) the attention branch is not added to the queries."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 widening_factor: int = 1, mlp_bias: bool = True, residual_dropout: float = 0.0,
                 attention_residual: bool = True, dtype: torch.dtype = torch.float32,
                 **attention_kwargs):
        super().__init__()
        self.attention_residual = attention_residual
        self.cross_attn = CrossAttention(
            num_heads, num_q_input_channels, num_kv_input_channels, dtype=dtype,
            **attention_kwargs,
        )
        self.mlp = MLP(num_q_input_channels, widening_factor, bias=mlp_bias, dtype=dtype)
        self.attn_residual = _ResidualDropout(residual_dropout)
        self.mlp_residual = _ResidualDropout(residual_dropout)

    def forward(self, x_q, x_kv=None, x_kv_prefix=None, pad_mask=None,
                rot_pos_emb_q=None, rot_pos_emb_k=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        attn = self.cross_attn(x_q, x_kv, x_kv_prefix, pad_mask, rot_pos_emb_q, rot_pos_emb_k,
                               deterministic, generator)
        x = self.attn_residual(attn, x_q, deterministic, generator) if self.attention_residual else attn
        return self.mlp_residual(self.mlp(x), x, deterministic, generator)


class SelfAttentionLayer(nn.Module):
    """Residual self-attention, then residual MLP, each branch through
    residual dropout."""

    def __init__(self, num_heads: int, num_channels: int, widening_factor: int = 1,
                 mlp_bias: bool = True, residual_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, **attention_kwargs):
        super().__init__()
        self.self_attn = SelfAttention(num_heads, num_channels, dtype=dtype, **attention_kwargs)
        self.mlp = MLP(num_channels, widening_factor, bias=mlp_bias, dtype=dtype)
        self.attn_residual = _ResidualDropout(residual_dropout)
        self.mlp_residual = _ResidualDropout(residual_dropout)

    def forward(self, x, pad_mask=None, rot_pos_emb=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        attn = self.self_attn(x, pad_mask, rot_pos_emb, deterministic, generator)
        x = self.attn_residual(attn, x, deterministic, generator)
        return self.mlp_residual(self.mlp(x), x, deterministic, generator)


class SelfAttentionBlock(nn.Module):
    """Stack of self-attention layers. Rotary embeddings reach only the first
    layer, the reference behaviour Perceiver AR checkpoints are trained with
    (the JAX ``rotary_all_layers=False``); ``pad_mask`` reaches every layer.
    ``checkpointing`` and ``offload`` go to :func:`remat` for each layer."""

    def __init__(self, num_layers: int, num_heads: int, num_channels: int,
                 widening_factor: int = 1, mlp_bias: bool = True, residual_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, **attention_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(
            SelfAttentionLayer(num_heads, num_channels, widening_factor, mlp_bias=mlp_bias,
                               residual_dropout=residual_dropout, dtype=dtype, **attention_kwargs)
            for _ in range(num_layers)
        )

    def forward(self, x, pad_mask=None, rot_pos_emb=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, checkpointing: bool = False,
                offload: bool = False):
        for i, layer in enumerate(self.layers):
            x = remat(layer, (x, pad_mask, rot_pos_emb if i == 0 else None), deterministic=deterministic,
                      generator=generator, enabled=checkpointing, offload=offload)
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

    ``post_attention_dropout`` and ``residual_dropout`` act in train mode
    on every layer (an attend with dropout takes the plain path, as in JAX).
    ``activation_checkpointing`` recomputes the cross-attention layer and
    every self-attention layer in the backward (:func:`remat`);
    ``activation_offloading`` adds the move of their inputs to pinned host
    memory, and does nothing without checkpointing, as in JAX.
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
        num_channels = input_adapter.num_input_channels
        self.cross_attention_dropout = cross_attention_dropout
        self.post_attention_dropout = post_attention_dropout
        self.residual_dropout = residual_dropout
        self.activation_checkpointing = activation_checkpointing
        self.activation_offloading = activation_offloading
        self.input_adapter = input_adapter
        attn = dict(causal_attention=True, qkv_bias=False, dropout=post_attention_dropout,
                    residual_dropout=residual_dropout, attention_impl=attention_impl)
        # as in JAX, only the cross-attention serialises its head groups
        self.cross_attention = CrossAttentionLayer(
            num_heads, num_channels, num_channels,
            widening_factor=cross_attention_widening_factor, mlp_bias=False, dtype=dtype,
            out_bias=True, max_heads_parallel=max_heads_parallel, **attn,
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
        # the caller left-pads x
        shift = None if pad_mask is None else pad_mask.sum(dim=1, keepdim=True)
        x, frq = self.input_adapter(x, abs_pos=positions(b, n, shift=shift, device=x.device))

        x_latent, x_prefix = x[:, prefix_len:], x[:, :prefix_len]
        frq_latent, frq_prefix = frq[:, prefix_len:], frq[:, :prefix_len]
        pad_latent = None if pad_mask is None else pad_mask[:, prefix_len:]
        pad_prefix = None if pad_mask is None else pad_mask[:, :prefix_len]
        if not deterministic and prefix_len > 0 and self.cross_attention_dropout > 0.0:
            keep = prefix_len - int(prefix_len * self.cross_attention_dropout)
            full, index = draw_shape((b, prefix_len))  # a rank's rows of the global draw
            idx = prefix_keep_indices(prefix_noise(*full, generator, x.device)[index], keep)
            x_prefix = torch.gather(x_prefix, 1, idx[..., None].expand(-1, -1, x_prefix.shape[-1]))
            frq_prefix = torch.gather(frq_prefix, 1, idx[..., None].expand(-1, -1, frq_prefix.shape[-1]))
            if pad_prefix is not None:
                pad_prefix = torch.gather(pad_prefix, 1, idx)
        if pad_mask is not None:
            pad_mask = torch.cat([pad_prefix, pad_latent], dim=1)

        args = (x_latent, None, x_prefix, pad_mask,
                RotaryEmbedding(frq_latent, right_align=True),
                RotaryEmbedding(torch.cat([frq_prefix, frq_latent], dim=1), right_align=True))
        ckpt, offload = self.activation_checkpointing, self.activation_offloading
        x_latent = remat(self.cross_attention, args, deterministic=deterministic, generator=generator,
                         enabled=ckpt, offload=offload)
        # Neither package masks the stack (JAX modules.py:1000-1005): a
        # latent whose cross-attention row saw no key is a key here. The
        # flash kernel gives that row 0, the einsum path a uniform average,
        # so with pads reaching into the latents the two differ on live rows.
        return self.self_attention(x_latent, None, RotaryEmbedding(frq_latent, right_align=True),
                                   deterministic, generator, checkpointing=ckpt, offload=offload)


class PerceiverEncoder(nn.Module):
    """Perceiver IO encoder: a trainable latent array cross-attends to the
    adapted input, then self-attention blocks run over the latents; the
    cross-attention repeats before the first ``num_cross_attention_layers``
    blocks. Weight sharing is module reuse: ``cross_attn_1`` / ``self_attn_1``
    run again at later depths unless an unshared ``cross_attn_n`` /
    ``self_attn_n`` is configured (JAX ``PerceiverEncoder``).
    ``activation_checkpointing`` recomputes each attention layer in the
    backward (:func:`remat`), ``activation_offloading`` moves their saved
    inputs to pinned host memory."""

    def __init__(self, input_adapter: nn.Module, num_latents: int, num_latent_channels: int,
                 num_cross_attention_heads: int = 4, num_cross_attention_qk_channels: Optional[int] = None,
                 num_cross_attention_v_channels: Optional[int] = None,
                 num_cross_attention_layers: int = 1, first_cross_attention_layer_shared: bool = False,
                 cross_attention_widening_factor: int = 1, num_self_attention_heads: int = 4,
                 num_self_attention_qk_channels: Optional[int] = None,
                 num_self_attention_v_channels: Optional[int] = None,
                 num_self_attention_layers_per_block: int = 6, num_self_attention_blocks: int = 1,
                 first_self_attention_block_shared: bool = True, self_attention_widening_factor: int = 1,
                 dropout: float = 0.0, residual_dropout: float = 0.0, init_scale: float = 0.02,
                 activation_checkpointing: bool = False, activation_offloading: bool = False,
                 dtype: torch.dtype = torch.float32, attention_impl: str = "auto"):
        super().__init__()
        if num_cross_attention_layers <= 0:
            raise ValueError("num_cross_attention_layers must be > 0")
        if num_self_attention_blocks <= 0:
            raise ValueError("num_self_attention_blocks must be > 0")
        if num_cross_attention_layers > num_self_attention_blocks:
            raise ValueError("num_cross_attention_layers must be <= num_self_attention_blocks")
        self.num_latents = num_latents
        self.num_latent_channels = num_latent_channels
        self.num_cross_attention_layers = num_cross_attention_layers
        self.num_self_attention_blocks = num_self_attention_blocks
        self.activation_checkpointing = activation_checkpointing
        self.activation_offloading = activation_offloading
        self.input_adapter = input_adapter
        self.latent_provider = TrainableQueryProvider(num_latents, num_latent_channels, init_scale, dtype)
        attn = dict(dropout=dropout, residual_dropout=residual_dropout, dtype=dtype,
                    attention_impl=attention_impl)

        def cross_attn():
            return CrossAttentionLayer(
                num_cross_attention_heads, num_latent_channels, input_adapter.num_input_channels,
                widening_factor=cross_attention_widening_factor,
                num_qk_channels=num_cross_attention_qk_channels,
                num_v_channels=num_cross_attention_v_channels, **attn)

        def self_attn():
            return SelfAttentionBlock(
                num_self_attention_layers_per_block, num_self_attention_heads, num_latent_channels,
                widening_factor=self_attention_widening_factor,
                num_qk_channels=num_self_attention_qk_channels,
                num_v_channels=num_self_attention_v_channels, **attn)

        self.cross_attn_1 = cross_attn()
        self.self_attn_1 = self_attn()
        self.extra_cross_attention_layer = (num_cross_attention_layers > 1
                                            and not first_cross_attention_layer_shared)
        self.extra_self_attention_block = (num_self_attention_blocks > 1
                                           and not first_self_attention_block_shared)
        if self.extra_cross_attention_layer:
            self.cross_attn_n = cross_attn()
        if self.extra_self_attention_block:
            self.self_attn_n = self_attn()

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                return_adapted_input: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """:return: the latents ``(b, num_latents, channels)``, and the adapted
        input with ``return_adapted_input``."""
        x_adapted = self.input_adapter(x)
        b = x_adapted.shape[0]
        x_latent = self.latent_provider().expand(b, -1, -1)
        ckpt = dict(deterministic=deterministic, generator=generator,
                    enabled=self.activation_checkpointing, offload=self.activation_offloading)
        blocks = dict(checkpointing=self.activation_checkpointing, offload=self.activation_offloading)
        cross_attn_n = self.cross_attn_n if self.extra_cross_attention_layer else self.cross_attn_1
        self_attn_n = self.self_attn_n if self.extra_self_attention_block else self.self_attn_1
        for i in range(self.num_self_attention_blocks):
            if i < self.num_cross_attention_layers:
                cross = self.cross_attn_1 if i == 0 else cross_attn_n
                x_latent = remat(cross, (x_latent, x_adapted, None, pad_mask), **ckpt)
            block = self.self_attn_1 if i == 0 else self_attn_n
            x_latent = block(x_latent, None, None, deterministic, generator, **blocks)
        return (x_latent, x_adapted) if return_adapted_input else x_latent


class PerceiverDecoder(nn.Module):
    """Perceiver IO decoder: output queries cross-attend to the latents, and
    ``output_adapter`` maps the result to the task's output. Without
    ``cross_attention_residual`` the attention branch is not added to the
    queries (the masked LM). ``output_query_provider`` may be None: the
    queries are then the adapted encoder input passed as ``x_adapted``."""

    def __init__(self, output_adapter: nn.Module, output_query_provider: Optional[nn.Module],
                 num_latent_channels: int, num_output_query_channels: int,
                 num_cross_attention_heads: int = 4, num_cross_attention_qk_channels: Optional[int] = None,
                 num_cross_attention_v_channels: Optional[int] = None,
                 cross_attention_widening_factor: int = 1, cross_attention_residual: bool = True,
                 dropout: float = 0.0, init_scale: float = 0.02, activation_checkpointing: bool = False,
                 activation_offloading: bool = False, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        self.activation_checkpointing = activation_checkpointing
        self.activation_offloading = activation_offloading
        self.output_adapter = output_adapter
        self.output_query_provider = output_query_provider
        self.cross_attn = CrossAttentionLayer(
            num_cross_attention_heads, num_output_query_channels, num_latent_channels,
            widening_factor=cross_attention_widening_factor, attention_residual=cross_attention_residual,
            num_qk_channels=num_cross_attention_qk_channels, num_v_channels=num_cross_attention_v_channels,
            dropout=dropout, dtype=dtype, attention_impl=attention_impl)

    def forward(self, x_latent: torch.Tensor, x_adapted: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                **adapter_kwargs) -> torch.Tensor:
        if self.output_query_provider is not None:
            output_query = self.output_query_provider(x_adapted)
            if output_query.shape[0] == 1 and x_latent.shape[0] > 1:
                output_query = output_query.expand(x_latent.shape[0], -1, -1)
        else:
            output_query = x_adapted
        output = remat(self.cross_attn, (output_query, x_latent), deterministic=deterministic,
                       generator=generator, enabled=self.activation_checkpointing,
                       offload=self.activation_offloading)
        return self.output_adapter(output, **adapter_kwargs)


class PerceiverIO(nn.Module):
    """An encoder and a decoder: the decoder reads the encoder's latents."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, x, pad_mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, **decoder_kwargs):
        x_latent = self.encoder(x, pad_mask=pad_mask, deterministic=deterministic, generator=generator)
        return self.decoder(x_latent, deterministic=deterministic, generator=generator, **decoder_kwargs)


def init_weights(module: nn.Module, init_scale: float, generator: torch.Generator) -> None:
    """The JAX package's initialisers: normal(``init_scale``) for linear and
    embedding weights and for query arrays (a query provider's own scale),
    zeros for biases, ones/zeros for layer norms."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TrainableQueryProvider):
                m.query.normal_(0.0, m.init_scale, generator=generator)
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, init_scale, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, init_scale, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


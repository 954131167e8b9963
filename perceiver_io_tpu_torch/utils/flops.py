"""Analytic compute and parameter estimators for the Perceiver AR scaling
study. Counterpart of ``perceiver_io_tpu/utils/flops.py`` (the reference's
``examples/scaling/clm/scaling/flops.py`` estimator; assumptions from Kaplan
et al. section 2.1 and the Chinchilla appendix): training FLOPs per latent
token of the decoder-equivalent self-attention stack and of the prefix
cross-attention extra, dataset-size helpers, ``C = 6N``, and
:func:`training_flops_per_step`, the absolute FLOPs of one training step
(the numerator of a model-FLOPs share).

:func:`count_params` counts an ``nn.Module``'s parameters; a model built on
the meta device (``with torch.device("meta")``) counts without allocating.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def count_params(model) -> int:
    """Parameter count of an ``nn.Module``."""
    return int(sum(p.numel() for p in model.parameters()))


@dataclass
class ComputeEstimator:
    """Training FLOPs per latent token for Perceiver AR (reference
    ``flops.py:7-88`` semantics: forward ≈ ⅓ of forward+backward)."""

    vocab_size: int
    max_seq_len: int
    num_latents: int

    @property
    def num_prefix(self) -> int:
        return self.max_seq_len - self.num_latents

    # -- per-component forward FLOPs per latent token ----------------------
    @staticmethod
    def _input_embed(num_channels: int) -> int:
        return 4 * num_channels

    @staticmethod
    def _mlp_layer(num_channels: int) -> int:
        return 16 * num_channels**2

    def _self_attn_layer(self, num_channels: int) -> int:
        qkv = 6 * num_channels**2
        attn = 2 * num_channels * self.num_latents
        out = 2 * num_channels**2
        return qkv + attn + out

    def _cross_attn_layer(self, num_channels: int) -> int:
        kv = 4 * num_channels**2
        attn = 2 * num_channels * self.num_latents
        return kv + attn

    def _final_logits(self, num_channels: int) -> int:
        return 2 * num_channels * self.vocab_size

    # -- public surface ----------------------------------------------------
    def self_attn(self, num_channels: int, num_layers: int) -> int:
        """fwd+bwd FLOPs per latent token of the decoder-equivalent stack
        (``num_layers`` includes the hybrid cross-attention layer)."""
        forward = (
            self._input_embed(num_channels)
            + self._self_attn_layer(num_channels) * num_layers
            + self._mlp_layer(num_channels) * num_layers
            + self._final_logits(num_channels)
        )
        return forward * 3

    def cross_attn(self, num_channels: int, prefix_dropout: float = 0.5) -> int:
        """fwd+bwd FLOPs per latent token of the prefix extra."""
        ratio = self.num_prefix / self.num_latents
        embed_prefix = self._input_embed(num_channels) * ratio
        attn_prefix = self._cross_attn_layer(num_channels) * ratio * (1.0 - prefix_dropout)
        return int(embed_prefix + attn_prefix) * 3

    def total(self, num_channels: int, num_layers: int, prefix_dropout: float = 0.5) -> int:
        return self.self_attn(num_channels, num_layers) + self.cross_attn(
            num_channels, prefix_dropout
        )


def flops_approx(num_params: int) -> int:
    """Kaplan ``C = 6N`` fwd+bwd FLOPs per token approximation."""
    return 6 * num_params


@dataclass
class ScalingLaw:
    """Compute-optimal allocation ``N_opt = k_n·C^a``, ``D_opt = k_d·C^b``
    (reference ``examples/scaling/clm/scaling/laws.py:7-35``)."""

    a: float
    b: float
    k_n: float
    k_d: float

    def n_opt(self, flops: float) -> float:
        return self.k_n * flops**self.a

    def d_opt(self, flops: float) -> float:
        return self.k_d * flops**self.b

    def __str__(self) -> str:
        return (
            f"N_opt = {self.k_n:.4f} * C ** {self.a:.2f}\n"
            f"D_opt = {self.k_d:.4f} * C ** {self.b:.2f}"
        )


def fit_power_law(xs, ys, m: float, k0: float = 0.5) -> float:
    """Least-squares fit of ``y = k·x^m`` for fixed exponent ``m``: closed
    form ``k = Σ(y·x^m) / Σ(x^2m)`` — no scipy dependency needed."""
    import numpy as np

    xs = np.asarray(xs, dtype=np.float64) ** m
    ys = np.asarray(ys, dtype=np.float64)
    return float((xs * ys).sum() / (xs * xs).sum())


def fit_scaling_law(flops_arr, params_arr, tokens_arr, a: float, b: float) -> ScalingLaw:
    """Fit compute-optimal coefficients from (C, N, D) triples of the runs on
    the loss-vs-compute frontier (reference ``laws.py:25-28``)."""
    return ScalingLaw(
        a=a,
        b=b,
        k_n=fit_power_law(flops_arr, params_arr, m=a),
        k_d=fit_power_law(flops_arr, tokens_arr, m=b),
    )


def num_training_tokens(num_steps: int, num_latents: int, batch_size: int) -> int:
    return batch_size * num_latents * num_steps


def num_training_steps(num_tokens: int, num_latents: int, batch_size: int) -> int:
    return math.ceil(num_tokens / num_latents / batch_size)


def training_flops(
    estimator: ComputeEstimator,
    num_channels: int,
    num_layers: int,
    num_steps: int,
    batch_size: int,
    prefix_dropout: float = 0.5,
) -> tuple:
    """(total training FLOPs, total latent tokens) for a run — the quantity
    the compute-optimal scaling curves are plotted over."""
    tokens = num_training_tokens(num_steps, estimator.num_latents, batch_size)
    per_token = estimator.total(num_channels, num_layers, prefix_dropout)
    return per_token * tokens, tokens


def training_flops_per_step(
    estimator: ComputeEstimator,
    num_channels: int,
    num_layers: int,
    batch_size: int,
    prefix_dropout: float = 0.0,
) -> int:
    """Absolute fwd+bwd FLOPs of ONE training step — MFU accounting for the
    benchmark (eval-mode prefix_dropout = 0 counts the full prefix)."""
    per_token = estimator.total(num_channels, num_layers, prefix_dropout)
    return per_token * batch_size * estimator.num_latents

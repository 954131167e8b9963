"""Importers for the DeepMind Hugging Face Perceiver models
(``PerceiverForMaskedLM`` = ``deepmind/language-perceiver``,
``PerceiverForImageClassificationFourier`` =
``deepmind/vision-perceiver-fourier``, ``PerceiverForOpticalFlow`` =
``deepmind/optical-flow-perceiver``) into the port. Counterpart of
``perceiver_io_tpu/convert/hf_import.py``.

The ``transformers`` state-dict keys are renamed into the reference
library's module layout, and :mod:`.torch_import` carries that into the
port's ``state_dict``. The ``*_config_from_hf`` functions read any object
with ``transformers.PerceiverConfig``'s attributes (a
``types.SimpleNamespace`` where ``transformers`` is not installed) and
give the port's config dataclasses.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from perceiver_io_tpu_torch.convert import torch_import


def _expand(module_map: Mapping[str, str], hf_sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Expand module-path renames to parameter keys present in ``hf_sd``."""
    out: Dict[str, Any] = {}
    for hf_base, ref_base in module_map.items():
        if hf_base in hf_sd:  # bare parameter (latents, position embeddings)
            out[ref_base] = hf_sd[hf_base]
            continue
        for suffix in (".weight", ".bias"):
            if hf_base + suffix in hf_sd:
                out[ref_base + suffix] = hf_sd[hf_base + suffix]
    return out


def _layer_map(hf: str, ref: str, *, residual: bool = True, self_attn: bool = False) -> Dict[str, str]:
    """transformers ``PerceiverLayer`` → reference
    CrossAttentionLayer/SelfAttentionLayer module paths (reference
    ``core/huggingface.py:26-57``)."""
    pre = f"{ref}.0.module" if residual else f"{ref}.0"
    m: Dict[str, str] = {}
    if self_attn:
        m[f"{hf}.attention.self.layernorm1"] = f"{pre}.norm"
    else:
        m[f"{hf}.attention.self.layernorm1"] = f"{pre}.q_norm"
        m[f"{hf}.attention.self.layernorm2"] = f"{pre}.kv_norm"
    m[f"{hf}.attention.self.query"] = f"{pre}.attention.q_proj"
    m[f"{hf}.attention.self.key"] = f"{pre}.attention.k_proj"
    m[f"{hf}.attention.self.value"] = f"{pre}.attention.v_proj"
    m[f"{hf}.attention.output.dense"] = f"{pre}.attention.o_proj"
    # reference MLP = Sequential(LayerNorm, Linear, GELU, Linear)
    m[f"{hf}.layernorm"] = f"{ref}.1.module.0"
    m[f"{hf}.mlp.dense1"] = f"{ref}.1.module.1"
    m[f"{hf}.mlp.dense2"] = f"{ref}.1.module.3"
    return m


def _encoder_map(num_self_attention_layers: int) -> Dict[str, str]:
    m = {"perceiver.embeddings.latents": "encoder.latent_provider._query"}
    m.update(_layer_map("perceiver.encoder.cross_attention", "encoder.cross_attn_1"))
    for i in range(num_self_attention_layers):
        m.update(
            _layer_map(
                f"perceiver.encoder.self_attends.{i}",
                f"encoder.self_attn_1.{i}",
                self_attn=True,
            )
        )
    return m


# -- masked language model -------------------------------------------------
def mlm_config_from_hf(config) -> Any:
    """``transformers.PerceiverConfig`` → :data:`MaskedLanguageModelConfig`
    (reference ``mlm/huggingface.py:116-155``)."""
    from perceiver_io_tpu_torch.models.core.config import PerceiverIOConfig
    from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
    from perceiver_io_tpu_torch.models.text.mlm import TextDecoderConfig

    assert config.hidden_act == "gelu"
    assert config.tie_word_embeddings
    encoder = TextEncoderConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        num_input_channels=config.d_model,
        num_cross_attention_qk_channels=config.qk_channels,
        num_cross_attention_v_channels=config.v_channels,
        num_cross_attention_heads=config.num_cross_attention_heads,
        num_self_attention_qk_channels=config.qk_channels,
        num_self_attention_v_channels=config.v_channels,
        num_self_attention_heads=config.num_self_attention_heads,
        num_self_attention_layers_per_block=config.num_self_attends_per_block,
        num_self_attention_blocks=config.num_blocks,
        cross_attention_widening_factor=config.cross_attention_widening_factor,
        self_attention_widening_factor=config.self_attention_widening_factor,
        dropout=config.attention_probs_dropout_prob,
        init_scale=config.initializer_range,
    )
    # transformers.PerceiverForMaskedLM hardcodes its decoder attention shape
    # (qk_channels=8*32, num_heads=8, v_channels=d_model) regardless of the
    # PerceiverConfig (transformers modeling_perceiver.py, PerceiverForMaskedLM
    # __init__) — the reference's convert_config gets away with config.qk_channels
    # only because the official checkpoint happens to have qk_channels=256.
    decoder = TextDecoderConfig(
        vocab_size=config.vocab_size,
        max_seq_len=config.max_position_embeddings,
        num_cross_attention_qk_channels=8 * 32,
        num_cross_attention_v_channels=config.d_model,
        num_cross_attention_heads=8,
        cross_attention_widening_factor=config.cross_attention_widening_factor,
        cross_attention_residual=False,
        dropout=config.attention_probs_dropout_prob,
        init_scale=config.initializer_range,
    )
    return PerceiverIOConfig(
        encoder,
        decoder,
        num_latents=config.num_latents,
        num_latent_channels=config.d_latents,
    )


def import_hf_masked_language_model(hf_state_dict: Mapping[str, Any], config) -> Dict[str, Any]:
    """``PerceiverForMaskedLM`` state dict → the port's ``state_dict``."""
    m = _encoder_map(config.encoder.num_self_attention_layers_per_block)
    m.update(
        {
            "perceiver.input_preprocessor.embeddings": "encoder.input_adapter.txt_embedding",
            "perceiver.input_preprocessor.position_embeddings": "encoder.input_adapter.pos_embedding",
            "perceiver.decoder.output_position_encodings.position_embeddings":
                "decoder.output_query_provider._query",
            "embedding_decoder.bias": "decoder.output_adapter.bias",
        }
    )
    m.update(
        _layer_map(
            "perceiver.decoder.decoding_cross_attention", "decoder.cross_attn",
            residual=config.decoder.cross_attention_residual,
        )
    )
    ref_sd = _expand(m, hf_state_dict)
    return torch_import.import_masked_language_model(ref_sd, config)


# -- image classifier (fourier) --------------------------------------------
def image_classifier_config_from_hf(config) -> Any:
    """``transformers.PerceiverConfig`` → :data:`ImageClassifierConfig`
    (reference ``image_classifier/huggingface.py:182-210``)."""
    from perceiver_io_tpu_torch.models.core.config import (
        ClassificationDecoderConfig,
        PerceiverIOConfig,
    )
    from perceiver_io_tpu_torch.models.vision.image_classifier import ImageEncoderConfig

    assert config.hidden_act == "gelu"
    encoder = ImageEncoderConfig(
        image_shape=(224, 224, 3),
        num_frequency_bands=64,
        num_cross_attention_heads=config.num_cross_attention_heads,
        num_self_attention_heads=config.num_self_attention_heads,
        num_self_attention_layers_per_block=config.num_self_attends_per_block,
        num_self_attention_blocks=config.num_blocks,
        dropout=config.attention_probs_dropout_prob,
        init_scale=config.initializer_range,
    )
    decoder = ClassificationDecoderConfig(
        num_classes=config.num_labels,
        num_output_query_channels=config.d_latents,
        num_cross_attention_heads=config.num_cross_attention_heads,
        cross_attention_residual=True,
        dropout=config.attention_probs_dropout_prob,
        init_scale=config.initializer_range,
    )
    return PerceiverIOConfig(
        encoder,
        decoder,
        num_latents=config.num_latents,
        num_latent_channels=config.d_latents,
    )


def import_hf_image_classifier(hf_state_dict: Mapping[str, Any], config) -> Dict[str, Any]:
    """``PerceiverForImageClassificationFourier`` state dict → the port's ``state_dict``."""
    m = _encoder_map(config.encoder.num_self_attention_layers_per_block)
    m.update(
        _layer_map("perceiver.decoder.decoder.decoding_cross_attention", "decoder.cross_attn")
    )
    m.update(
        {
            "perceiver.decoder.decoder.output_position_encodings.position_embeddings":
                "decoder.output_query_provider._query",
            "perceiver.decoder.decoder.final_layer": "decoder.output_adapter.linear",
        }
    )
    ref_sd = _expand(m, hf_state_dict)
    return torch_import.import_image_classifier(ref_sd, config)


# -- optical flow ----------------------------------------------------------
def optical_flow_config_from_hf(config) -> Any:
    """``transformers.PerceiverConfig`` → :data:`OpticalFlowConfig` (the
    mapping the reference does in ``optical_flow/huggingface.py:177-203``,
    corrected to what transformers actually builds: the flow preprocessor
    hardcodes 64 post-patch channels + 64 Fourier bands
    (``modeling_perceiver.py`` ``PerceiverForOpticalFlow.__init__``), and
    ``PerceiverBasicDecoder`` defaults give the decoder ONE head with
    qk = v = kv channels (``cross_attention_shape_for_attention="kv"`` →
    the latent width) — not the config's qk/v settings."""
    from perceiver_io_tpu_torch.models.core.config import PerceiverIOConfig
    from perceiver_io_tpu_torch.models.vision.optical_flow import (
        OpticalFlowDecoderConfig,
        OpticalFlowEncoderConfig,
    )

    assert config.hidden_act == "gelu"
    image_shape = tuple(config.train_size)
    num_bands = 64
    hidden = 64  # PerceiverImagePreprocessor out_channels default
    query_channels = hidden + 2 * (2 * num_bands + 1)  # + concat fourier pos
    assert config.d_model == query_channels, (
        f"flow d_model must be {query_channels} (64 patch channels + fourier), "
        f"got {config.d_model}"
    )
    encoder = OpticalFlowEncoderConfig(
        image_shape=image_shape,
        num_patch_input_channels=27,
        num_patch_hidden_channels=hidden,
        num_frequency_bands=num_bands,
        num_cross_attention_qk_channels=config.qk_channels,
        num_cross_attention_v_channels=config.v_channels,
        num_cross_attention_heads=config.num_cross_attention_heads,
        num_self_attention_qk_channels=config.qk_channels,
        num_self_attention_v_channels=config.v_channels,
        num_self_attention_heads=config.num_self_attention_heads,
        num_self_attention_layers_per_block=config.num_self_attends_per_block,
        num_self_attention_blocks=config.num_blocks,
        cross_attention_widening_factor=config.cross_attention_widening_factor,
        self_attention_widening_factor=config.self_attention_widening_factor,
        dropout=config.attention_probs_dropout_prob,
        init_scale=config.initializer_range,
    )
    decoder = OpticalFlowDecoderConfig(
        image_shape=image_shape,
        num_cross_attention_qk_channels=config.d_latents,
        num_cross_attention_v_channels=config.d_latents,
        num_cross_attention_heads=1,
        cross_attention_widening_factor=config.cross_attention_widening_factor,
        cross_attention_residual=False,
        dropout=config.attention_probs_dropout_prob,
        init_scale=config.initializer_range,
        rescale_factor=100.0,
    )
    return PerceiverIOConfig(
        encoder,
        decoder,
        num_latents=config.num_latents,
        num_latent_channels=config.d_latents,
    )


def import_hf_optical_flow(hf_state_dict: Mapping[str, Any], config) -> Dict[str, Any]:
    """``PerceiverForOpticalFlow`` state dict → the port's ``state_dict`` (module
    correspondence per reference ``optical_flow/huggingface.py:177-203``:
    ``conv_after_patches`` is the patch embedding, the decoder queries are
    the adapted inputs so there is no trainable query)."""
    m = _encoder_map(config.encoder.num_self_attention_layers_per_block)
    m.update(
        _layer_map(
            "perceiver.decoder.decoder.decoding_cross_attention", "decoder.cross_attn",
            residual=config.decoder.cross_attention_residual,
        )
    )
    m.update(
        {
            "perceiver.input_preprocessor.conv_after_patches": "encoder.input_adapter.linear",
            "perceiver.decoder.decoder.final_layer": "decoder.output_adapter.linear",
        }
    )
    ref_sd = _expand(m, hf_state_dict)
    return torch_import.import_optical_flow(ref_sd, config)

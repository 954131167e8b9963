"""Task pipelines. Counterpart of ``perceiver_io_tpu/inference/pipelines.py``,
every task of it: ``text-generation``, ``fill-mask``,
``sentiment-analysis`` / ``text-classification``,
``image-classification``, ``optical-flow`` and
``symbolic-audio-generation`` (:class:`TextGenerationPipeline`,
:class:`FillMaskPipeline`, :class:`TextClassificationPipeline`,
:class:`ImageClassificationPipeline`, :class:`OpticalFlowPipeline`,
:class:`SymbolicAudioPipeline`), the :func:`pipeline` dispatch by task
name, and :func:`pipeline_from_pretrained` over a ``save_pretrained`` dir
(with :func:`cast_float_params` for bf16 weight storage).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.inference.mask_filler import MaskFiller
from perceiver_io_tpu_torch.inference.samplers import SamplingConfig
from perceiver_io_tpu_torch.models import model_for_config


def _warn_sampling_ignored_under_beam(num_beams, temperature, top_k, top_p):
    """Beam dispatch is deterministic; sampling knobs would be silently
    dropped (HF warns the same way for ``temperature`` + ``do_sample=False``)."""
    if num_beams > 1 and (temperature != 1.0 or top_k is not None or top_p is not None):
        warnings.warn(
            "temperature/top_k/top_p are ignored when num_beams > 1 — beam "
            "search decodes deterministically",
            UserWarning,
            stacklevel=3,
        )


def _pad_batch(rows: List[np.ndarray], pad_id: int, side: str) -> Tuple[np.ndarray, np.ndarray]:
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), pad_id, np.int32)
    for i, row in enumerate(rows):
        if side == "left":
            out[i, width - len(row):] = row
        else:
            out[i, : len(row)] = row
    return out, out == pad_id


class TextGenerationPipeline:
    """``pipeline("text-generation")``: prompts -> continuation text through
    :func:`~.generate.generate`.

    With ``bucketing=True`` calls of one beam go through the bucket engine
    (:class:`~perceiver_io_tpu_torch.serving.engine.ServingEngine`): prompts
    are padded to a static bucket grid and micro-batched. Greedy output is
    token-identical either way (generation is left-pad invariant);
    ``serving_stats()`` exposes the engine counters.

    As in the reference, ``temperature``/``top_k``/``top_p`` never turn
    sampling on (``do_sample`` stays False), so they leave decoding greedy,
    as HF does without ``do_sample``.
    """

    def __init__(self, model, tokenizer, *, bucketing: bool = False, bucket_table=None,
                 decode_strategy: Optional[str] = None, device: DeviceLike = "cuda"):
        self.model = model
        self.tokenizer = tokenizer
        self.bucketing = bucketing
        self._bucket_table = bucket_table
        #: the decode strategy of every generate call and of the engine;
        #: None defers to PERCEIVER_DECODE_STRATEGY / the measured registry
        self.decode_strategy = decode_strategy
        self.device = resolve_device(device)
        self._engine = None

    def _make_config(
        self, *, max_new_tokens: int = 64, min_new_tokens: int = 0,
        num_latents: int = 1, temperature: float = 1.0,
        top_k: Optional[int] = None, top_p: Optional[float] = None,
        repetition_penalty: float = 1.0, num_beams: int = 1,
        length_penalty: float = 1.0,
    ) -> GenerationConfig:
        return GenerationConfig(
            max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens,
            num_latents=num_latents,
            pad_token_id=self.tokenizer.pad_token_id or 0,
            eos_token_id=self.tokenizer.eos_token_id,
            num_beams=num_beams,
            length_penalty=length_penalty,
            sampling=SamplingConfig(temperature=temperature, top_k=top_k, top_p=top_p,
                                    repetition_penalty=repetition_penalty),
        )

    def _ensure_engine(self, config: GenerationConfig):
        if self._engine is None:
            from perceiver_io_tpu_torch.serving.engine import ServingEngine

            self._engine = ServingEngine(
                self.model, config, table=self._bucket_table,
                decode_strategy=self.decode_strategy, device=self.device,
            )
        return self._engine

    def warmup(self, **gen_kwargs) -> int:
        """Drive every serving bucket once (``bucketing=True`` only); returns
        the number of ``generate`` calls."""
        if not self.bucketing:
            raise ValueError("warmup() requires bucketing=True")
        config = self._make_config(**gen_kwargs)
        return self._ensure_engine(config).warmup(config)

    def serving_stats(self) -> Optional[dict]:
        """Engine counters, or None when bucketing is off or nothing was
        served yet."""
        return self._engine.stats() if self._engine is not None else None

    def __call__(
        self,
        prompts: Union[str, Sequence[str]],
        *,
        max_new_tokens: int = 64,
        min_new_tokens: int = 0,
        num_latents: int = 1,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        repetition_penalty: float = 1.0,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        seed: int = 0,
        return_full_text: bool = True,
    ) -> List[str]:
        _warn_sampling_ignored_under_beam(num_beams, temperature, top_k, top_p)
        single = isinstance(prompts, str)
        batch = [prompts] if single else list(prompts)
        encoded = [np.asarray(self.tokenizer.encode(p), np.int32) for p in batch]
        pad_id = self.tokenizer.pad_token_id or 0

        config = self._make_config(
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            num_latents=num_latents, temperature=temperature, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty,
            num_beams=num_beams, length_penalty=length_penalty,
        )
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.bucketing and num_beams == 1:
            rows = self._ensure_engine(config).serve(encoded, config, generator=generator)
        else:
            ids, pad = _pad_batch(encoded, pad_id, "left")
            pad_count = pad.sum(axis=1).astype(np.int32)
            rows = generate(
                self.model, ids, config, generator=generator, prompt_pad_count=pad_count,
                decode_strategy=self.decode_strategy, device=self.device,
            ).cpu().numpy()
        texts = []
        for prompt, row in zip(batch, rows):
            new = self.tokenizer.decode([t for t in row.tolist() if t != pad_id])
            texts.append(prompt + new if return_full_text else new)
        return texts[0:1] if single else texts


class FillMaskPipeline:
    """``pipeline("fill-mask")``: the top-k fillings of each masked text
    (``<mask>`` marks a masked token) through :class:`~.mask_filler.MaskFiller`
    on the model's device. ``device`` is where the model lies (the pipeline
    factories pass it); the model is not moved."""

    def __init__(self, model, preprocessor, *, device: DeviceLike = "cuda"):
        self.model = model
        self.device = resolve_device(device)
        self._filler = MaskFiller(preprocessor)

    def __call__(self, texts: Union[str, Sequence[str]], *, top_k: int = 5) -> List[List[str]]:
        batch = [texts] if isinstance(texts, str) else list(texts)
        _, filled = self._filler.fill(self.model, batch, top_k)
        return filled


class TextClassificationPipeline:
    """``pipeline("sentiment-analysis")`` / ``pipeline("text-classification")``:
    texts -> ``{"label", "score"}`` of the most likely class (softmax of
    the fp32 logits), through ``preprocessor.preprocess_batch`` (a
    :class:`~perceiver_io_tpu_torch.data.text.TextPreprocessor`) and the
    model on its device."""

    def __init__(self, model, preprocessor, labels: Sequence[str] = ("NEGATIVE", "POSITIVE"), *,
                 device: DeviceLike = "cuda"):
        self.model = model
        self.preprocessor = preprocessor
        self.labels = list(labels)
        self.device = resolve_device(device)

    def __call__(self, texts: Union[str, Sequence[str]]) -> List[Dict[str, Any]]:
        batch = [texts] if isinstance(texts, str) else list(texts)
        ids, pad = self.preprocessor.preprocess_batch(batch)
        with torch.no_grad():
            logits = self.model(torch.as_tensor(np.asarray(ids), device=self.device).long(),
                                pad_mask=torch.as_tensor(np.asarray(pad), device=self.device))
        probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        out = []
        for row in probs:
            idx = int(row.argmax())
            out.append({"label": self.labels[idx], "score": float(row[idx])})
        return out


class ImageClassificationPipeline:
    """``pipeline("image-classification")``: channels-last uint8 images ->
    the top-k ``{"label", "score"}`` of each (softmax of the fp32 logits,
    ranked by ``np.argsort(-probs)``), through ``preprocessor`` (default
    :class:`~perceiver_io_tpu_torch.data.vision.ImagePreprocessor`) and the
    model on its device. Without ``labels`` a label is the class index."""

    def __init__(self, model, preprocessor=None, labels: Optional[Sequence[str]] = None, *,
                 device: DeviceLike = "cuda"):
        from perceiver_io_tpu_torch.data.vision import ImagePreprocessor

        self.model = model
        self.preprocessor = preprocessor or ImagePreprocessor()
        self.labels = labels
        self.device = resolve_device(device)

    def __call__(self, images: np.ndarray, *, top_k: int = 1) -> List[List[Dict[str, Any]]]:
        x = self.preprocessor(np.asarray(images))
        with torch.no_grad():
            logits = self.model(torch.as_tensor(np.asarray(x), device=self.device))
        probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        results = []
        for row in probs:
            order = np.argsort(-row)[:top_k]
            results.append([{"label": self.labels[i] if self.labels else int(i), "score": float(row[i])}
                            for i in order])
        return results


class OpticalFlowPipeline:
    """``pipeline("optical-flow")``: frame pairs -> per-pixel flow through
    :class:`~perceiver_io_tpu_torch.data.vision.OpticalFlowProcessor`: each
    pair is cut into overlapping patches of ``patch_size``, the patches run
    through the model on its device in micro-batches of ``batch_size`` (the
    last zero-padded), and the patches' flow is blended back into the
    frame; with ``render=True`` the flow comes back as RGB images
    (:func:`~perceiver_io_tpu_torch.data.vision.render_optical_flow`).

    One pair (two ``(h, w, c)`` or ``(h, w)`` arrays) gives ``(h, w, 2)``
    flow, a list of pairs ``(n, h, w, 2)``."""

    def __init__(self, model, *, patch_size: Tuple[int, int] = (368, 496), patch_min_overlap: int = 20,
                 batch_size: int = 1, render: bool = False, device: DeviceLike = "cuda"):
        from perceiver_io_tpu_torch.data.vision import OpticalFlowProcessor

        self.model = model
        self.processor = OpticalFlowProcessor(patch_size=patch_size, patch_min_overlap=patch_min_overlap)
        self.batch_size = batch_size
        self.render = render
        self.device = resolve_device(device)

    def _forward(self, x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.model(torch.as_tensor(x, device=self.device)).float().cpu().numpy()

    def __call__(self, image_pairs: Union[Tuple[np.ndarray, np.ndarray], Sequence[Tuple[np.ndarray, np.ndarray]]]):
        single = len(image_pairs) == 2 and isinstance(image_pairs[0], np.ndarray) and image_pairs[0].ndim >= 2
        pairs = [image_pairs] if single else list(image_pairs)
        flow = self.processor.process(self._forward, pairs, batch_size=self.batch_size)
        if self.render:
            from perceiver_io_tpu_torch.data.vision import render_optical_flow

            rendered = np.stack([render_optical_flow(f) for f in flow])
            return rendered[0] if single else rendered
        return flow[0] if single else flow


class SymbolicAudioPipeline:
    """``pipeline("symbolic-audio-generation")``: event-id prompts (MIDI
    events, :mod:`perceiver_io_tpu_torch.data.audio.midi`) -> prompt plus
    generated events through :func:`~.generate.generate`; MIDI out with
    ``pretty_midi`` (:meth:`generate_midi`), and WAV rendering through the
    ``fluidsynth`` CLI (:meth:`render_wav`).

    Prompts are left-padded with ``PAD_TOKEN`` (388). Decoding is greedy by
    default (the JAX package's pipeline never samples: its
    ``temperature``/``top_k``/``top_p`` leave ``do_sample`` False);
    ``do_sample=True`` samples from ``seed``'s ``torch.Generator`` on the
    pipeline's device, and ``num_beams > 1`` runs beam search.
    """

    def __init__(self, model, *, decode_strategy: Optional[str] = None, device: DeviceLike = "cuda"):
        self.model = model
        #: the decode strategy of every generate call; None defers to
        #: PERCEIVER_DECODE_STRATEGY / the measured registry
        self.decode_strategy = decode_strategy
        self.device = resolve_device(device)

    def __call__(
        self,
        prompts: Union[Sequence[int], Sequence[Sequence[int]], np.ndarray],
        *,
        max_new_tokens: int = 256,
        min_new_tokens: int = 0,
        num_latents: int = 1,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        repetition_penalty: float = 1.0,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        seed: int = 0,
    ) -> List[np.ndarray]:
        """Each prompt followed by its generated event ids (int32 arrays)."""
        from perceiver_io_tpu_torch.data.audio.midi import PAD_TOKEN

        _warn_sampling_ignored_under_beam(num_beams, temperature, top_k, top_p)
        if isinstance(prompts, np.ndarray) and prompts.ndim == 1:
            batch = [np.asarray(prompts, np.int32)]
        elif isinstance(prompts, (list, tuple)) and prompts and np.isscalar(prompts[0]):
            batch = [np.asarray(prompts, np.int32)]  # one flat prompt
        else:
            batch = [np.asarray(r, np.int32) for r in prompts]  # a ragged batch
        ids, pad = _pad_batch(batch, PAD_TOKEN, "left")
        pad_count = pad.sum(axis=1).astype(np.int32)
        config = GenerationConfig(
            max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens,
            num_latents=num_latents,
            pad_token_id=PAD_TOKEN,
            num_beams=num_beams,
            length_penalty=length_penalty,
            sampling=SamplingConfig(do_sample=do_sample, temperature=temperature, top_k=top_k,
                                    top_p=top_p, repetition_penalty=repetition_penalty),
        )
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out = generate(
            self.model, ids, config, generator=generator, prompt_pad_count=pad_count,
            decode_strategy=self.decode_strategy, device=self.device,
        ).cpu().numpy().astype(np.int32)
        return [np.concatenate([p, row]) for p, row in zip(batch, out)]

    def generate_midi(self, prompt_events: Sequence[int], path=None, **kwargs):
        """Generate and decode to a ``pretty_midi`` object, written to ``path``
        when given (raises ``ImportError`` without ``pretty_midi``)."""
        from perceiver_io_tpu_torch.data.audio.midi import decode_to_midi_file

        events = self([np.asarray(prompt_events, np.int32)], **kwargs)[0]
        return decode_to_midi_file(events, path)

    @staticmethod
    def render_wav(midi_path: str, wav_path: str, sound_font: str) -> None:
        """Render a MIDI file to WAV through the ``fluidsynth`` CLI."""
        import subprocess

        subprocess.run(["fluidsynth", "-ni", sound_font, midi_path, "-F", wav_path], check=True)


_TASKS = {"text-generation": TextGenerationPipeline,
          "fill-mask": FillMaskPipeline,
          "sentiment-analysis": TextClassificationPipeline,
          "text-classification": TextClassificationPipeline,
          "image-classification": ImageClassificationPipeline,
          "optical-flow": OpticalFlowPipeline,
          "symbolic-audio-generation": SymbolicAudioPipeline}
#: the JAX package's tasks that the port does not have (none)
_UNPORTED_TASKS = ()


def pipeline(task: str, model, *args, **kwargs):
    """``transformers.pipeline``-shaped dispatch by task name."""
    if task in _UNPORTED_TASKS:
        raise NotImplementedError(f"the {task!r} pipeline is not ported yet")
    if task not in _TASKS:
        raise ValueError(f"unknown task {task!r}; available: {sorted(_TASKS)}")
    return _TASKS[task](model, *args, **kwargs)


def cast_float_params(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Store ``model``'s floating parameters in ``dtype`` (integer and bool
    tensors untouched); returns the model. For inference: bf16 storage
    halves the weight traffic of every matmul in the decode loop. Training
    keeps fp32 parameters."""
    return model.to(dtype=dtype)


def pipeline_from_pretrained(task: str, path: str, *args, dtype: Optional[torch.dtype] = None,
                             params_dtype: Optional[torch.dtype] = None,
                             attention_impl: str = "auto", device: DeviceLike = "cuda", **kwargs):
    """A pipeline straight from a ``save_pretrained`` dir (or a trainer
    checkpoint dir): its embedded config picks the model class.

    :param dtype: computation type (None: fp32).
    :param params_dtype: storage type of the loaded weights
        (:func:`cast_float_params`); None keeps the checkpoint's.
    :param device: where the model and the pipeline run; ``"cuda"`` by
        default, the CPU only when asked for.
    """
    from perceiver_io_tpu_torch.training.checkpoint import load_pretrained

    dev = resolve_device(device)
    state, config = load_pretrained(path)
    if config is None:
        raise ValueError(f"{path} has no embedded model config")
    model = model_for_config(config, dtype=dtype, attention_impl=attention_impl, device=dev)
    model.load_state_dict(state, strict=True)
    if params_dtype is not None:
        cast_float_params(model, params_dtype)
    return pipeline(task, model, *args, device=dev, **kwargs)

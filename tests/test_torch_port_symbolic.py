"""The port's symbolic-audio model, its pipeline, serving and training
against the JAX package, on the CPU.

One small ``SymbolicAudioModel`` (the 389-event vocabulary, 96 context, 32
latents, 64 channels, 2 heads, 2 layers; JAX params from a seed through
``convert.from_jax``: the parameter names are the causal LM's, so the
converter needs nothing new). Bars: logits within 1e-5; greedy
``generate()`` over latent growth, the boundary and the sliding window,
and the ``symbolic-audio-generation`` pipeline, token-identical to JAX's;
the sampled pipeline (temperature 1.0, top-k 15) equal to JAX's sampled
``generate()`` under JAX's Gumbel draws replayed through
``samplers.gumbel_noise`` (JAX's pipeline exposes no ``do_sample``); beam
search on the setup of ``tests/test_pipelines.py``
``test_symbolic_audio_pipeline_beam`` equal to JAX's; the paged slot engine
equal to JAX's on one script; three ``Trainer.fit`` steps over
``SyntheticSymbolicAudioDataModule`` batches at JAX's losses (1e-5
relative); ``model_for_config`` and ``pipeline_from_pretrained`` round trips.
"""
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModel as JaxSAM
from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModelConfig as JaxSAMConfig
from perceiver_io_tpu.parallel import MeshConfig, make_mesh
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu.training.trainer import Trainer as JaxTrainer
from perceiver_io_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.data.audio import PAD_TOKEN, SyntheticSymbolicAudioDataModule, notes_from_events
from perceiver_io_tpu_torch.inference import samplers
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.inference.pipelines import SymbolicAudioPipeline, pipeline, pipeline_from_pretrained
from perceiver_io_tpu_torch.models import model_for_config
from perceiver_io_tpu_torch.models.audio import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine
from perceiver_io_tpu_torch.training import Trainer, TrainerConfig, clm_loss_fn, make_optimizer
from perceiver_io_tpu_torch.training.checkpoint import load_pretrained, save_pretrained

jax_gen = importlib.import_module("perceiver_io_tpu.inference.generate")
jax_samplers = importlib.import_module("perceiver_io_tpu.inference.samplers")
jax_pipelines = importlib.import_module("perceiver_io_tpu.inference.pipelines")
jax_checkpoint = importlib.import_module("perceiver_io_tpu.training.checkpoint")

KW = dict(max_seq_len=96, max_latents=32, num_channels=64, num_heads=2, num_self_attention_layers=2,
          cross_attention_dropout=0.0, init_scale=0.1)
SEQ, LATENTS = KW["max_seq_len"], KW["max_latents"]
# the model of tests/test_pipelines.py test_symbolic_audio_pipeline_beam
BEAM_KW = dict(max_seq_len=32, max_latents=16, num_channels=32, num_heads=2,
               num_self_attention_layers=1, cross_attention_dropout=0.0)


def _pair(kw, key=3):
    n = kw["max_seq_len"]
    j_model = JaxSAM(JaxSAMConfig(**kw))
    params = jax.jit(j_model.init, static_argnums=2)(
        jax.random.PRNGKey(key), jnp.zeros((1, n), jnp.int32), n - kw["max_latents"])["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    config = SymbolicAudioModelConfig(**kw)
    return j_model, params, config, load_jax_params(SymbolicAudioModel(config, device="cpu"), params).eval()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    return _pair(KW)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, PAD_TOKEN, n).astype(np.int32) for n in lens]


def _left_pad(prompts):
    width = max(len(p) for p in prompts)
    ids = np.full((len(prompts), width), PAD_TOKEN, np.int32)
    for r, p in enumerate(prompts):
        ids[r, width - len(p):] = p
    return ids, (ids == PAD_TOKEN).sum(1).astype(np.int32)


def test_config_and_logits_match_jax(pair):
    j_model, params, config, t_model = pair
    assert SymbolicAudioModelConfig() == SymbolicAudioModelConfig(
        vocab_size=389, max_seq_len=4096, max_latents=1024, num_channels=512)
    assert {f.name: getattr(SymbolicAudioModelConfig(), f.name)
            for f in dataclasses.fields(SymbolicAudioModelConfig)} == {
        f.name: getattr(JaxSAMConfig(), f.name) for f in dataclasses.fields(SymbolicAudioModelConfig)}
    ids, pads = _left_pad(_prompts([96, 70, 50], seed=1))
    pad = ids == PAD_TOKEN
    want = jax.jit(j_model.apply, static_argnames="prefix_len")(
        {"params": params}, jnp.asarray(ids), prefix_len=SEQ - LATENTS, pad_mask=jnp.asarray(pad))
    with torch.no_grad():
        got = t_model(torch.from_numpy(ids), prefix_len=SEQ - LATENTS, pad_mask=torch.from_numpy(pad))
    assert got.shape == (3, LATENTS, 389)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert sum(p.numel() for p in t_model.parameters()) == sum(
        np.size(x) for x in jax.tree_util.tree_leaves(params))


def test_greedy_generate_and_pipeline_match_jax(pair):
    j_model, params, _, t_model = pair
    # 26 of 32 latents: 6 growth steps, then the boundary; 90 + 10 > 96: the window
    prompts = _prompts([70, 90, 33])
    ids, pads = _left_pad(prompts)
    cfg = GenerationConfig(max_new_tokens=10, num_latents=26, pad_token_id=PAD_TOKEN)
    want = jax_gen.generate(j_model, params, jnp.asarray(ids),
                            jax_gen.GenerationConfig(max_new_tokens=10, num_latents=26, pad_token_id=PAD_TOKEN),
                            prompt_pad_count=jnp.asarray(pads))
    got = generate(t_model, ids, cfg, prompt_pad_count=pads, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    call = dict(max_new_tokens=10, num_latents=26)
    j_out = jax_pipelines.pipeline("symbolic-audio-generation", j_model, params)(prompts, **call)
    pipe = pipeline("symbolic-audio-generation", t_model, device="cpu")
    assert isinstance(pipe, SymbolicAudioPipeline)
    out = pipe(prompts, **call)
    assert len(out) == 3
    for o, j, p in zip(out, j_out, prompts):
        assert o.dtype == np.int32 and len(o) == len(p) + 10
        np.testing.assert_array_equal(o, np.asarray(j))
    # a single flat prompt, and the sampling knobs without do_sample: greedy
    np.testing.assert_array_equal(pipe(list(prompts[0]), temperature=0.7, top_k=3, **call)[0], out[0])


class _Replay:
    """Stands in for ``samplers.gumbel_noise``: each call returns JAX's
    Gumbel draw of the next key (``split(PRNGKey(seed), max_new_tokens)[t]``,
    JAX ``generate``'s), at the shape the port asks for."""

    def __init__(self, seed, steps):
        self.keys = iter(jax.random.split(jax.random.PRNGKey(seed), steps))

    def __call__(self, shape, generator, device):
        return torch.from_numpy(np.array(jax.random.gumbel(next(self.keys), tuple(shape), jnp.float32)))


@pytest.mark.parametrize("seed", [0, 7])
def test_sampled_pipeline_matches_jax_draws(pair, monkeypatch, seed):
    j_model, params, _, t_model = pair
    prompts = _prompts([40, 64], seed=seed)
    ids, pads = _left_pad(prompts)
    want = jax_gen.generate(
        j_model, params, jnp.asarray(ids),
        jax_gen.GenerationConfig(max_new_tokens=12, num_latents=8, pad_token_id=PAD_TOKEN,
                                 sampling=jax_samplers.SamplingConfig(do_sample=True, temperature=1.0, top_k=15)),
        rng=jax.random.PRNGKey(seed), prompt_pad_count=jnp.asarray(pads))
    monkeypatch.setattr(samplers, "gumbel_noise", _Replay(seed, 12))
    out = SymbolicAudioPipeline(t_model, device="cpu")(
        prompts, max_new_tokens=12, num_latents=8, do_sample=True, temperature=1.0, top_k=15, seed=seed)
    for o, p, w in zip(out, prompts, np.asarray(want)):
        np.testing.assert_array_equal(o[len(p):], w)
        assert ((o >= 0) & (o < PAD_TOKEN)).all()
        notes_from_events(o)  # decodes


def test_sampled_pipeline_on_its_own_generator(pair):
    _, _, _, t_model = pair
    pipe = SymbolicAudioPipeline(t_model, device="cpu")
    call = dict(max_new_tokens=16, num_latents=8, do_sample=True, top_k=15)
    a, again, b = (pipe(_prompts([30]), seed=s, **call)[0] for s in (1, 1, 2))
    np.testing.assert_array_equal(a, again)
    assert not np.array_equal(a, b) and (a < PAD_TOKEN).all()


def test_beam_pipeline_matches_jax():
    j_model, params, _, t_model = _pair(BEAM_KW, key=0)
    prompt = np.array([60, 256 + 49, 128 + 60], np.int32)
    call = dict(max_new_tokens=5, num_latents=4, num_beams=3)
    want = jax_pipelines.pipeline("symbolic-audio-generation", j_model, params)([prompt], **call)
    got = pipeline("symbolic-audio-generation", t_model, device="cpu")([prompt], **call)
    assert len(got) == 1 and len(got[0]) == len(prompt) + 5
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


def test_paged_slot_engine_matches_jax(pair):
    j_model, params, _, t_model = pair
    prompts = _prompts([30, 50, 64, 40], seed=4)
    news = [8, 5, 8, 6]
    buckets = dict(prompt_lens=(32, 64, 90), batch_sizes=(1,))  # 90 - 26 latents <= 64 prefix slots
    j_cfg = jax_gen.GenerationConfig(max_new_tokens=8, num_latents=26, pad_token_id=PAD_TOKEN)
    j_eng = JaxSlotServingEngine(j_model, params, j_cfg, JaxBucketTable(**buckets), slots=2,
                                 kv_layout="paged", kv_block_size=8)
    j_reqs = [j_eng.submit(p, config=dataclasses.replace(j_cfg, max_new_tokens=k)) for p, k in zip(prompts, news)]
    j_eng.run_until_idle()
    cfg = GenerationConfig(max_new_tokens=8, num_latents=26, pad_token_id=PAD_TOKEN)
    eng = SlotServingEngine(t_model, cfg, BucketTable(**buckets), slots=2, kv_layout="paged",
                            kv_block_size=8, device="cpu")
    reqs = [eng.submit(p, dataclasses.replace(cfg, max_new_tokens=k)) for p, k in zip(prompts, news)]
    eng.run_until_idle()
    for r, j in zip(reqs, j_reqs):
        assert r.status == "ok"
        np.testing.assert_array_equal(r.result, np.asarray(j.result))
    stats, j_stats = eng.stats(), j_eng.stats()
    assert stats["boundary_steps"] > 0 and stats["decode_steps"] == j_stats["decode_steps"]
    for key in ("allocs_total", "frees_total", "high_water"):
        assert stats["kv_pool"][key] == j_stats["kv_pool"][key]
    assert eng._pool.in_use == 0 and eng._pool.leaked() == 0


def test_trainer_fit_on_synthetic_batches_matches_jax(pair, tmp_path):
    j_model, params, config, t_model = pair
    t_model = load_jax_params(SymbolicAudioModel(config, device="cpu"), params)  # fresh weights to train
    dm = SyntheticSymbolicAudioDataModule(SEQ, num_train_pieces=5, num_valid_pieces=1, num_test_pieces=0,
                                          mean_piece_len=300, batch_size=4, min_seq_len=70, seed=2,
                                          shard_index=0, shard_count=1)
    dm.setup()
    batches = list(dm.train_dataloader())[:3]
    assert len(batches) == 3 and (batches[0]["pad_mask"].sum(1) > 0).any()  # the curriculum pads
    common = dict(max_steps=3, log_every_n_steps=1, grad_clip_norm=1.0, enable_tensorboard=False)
    JaxTrainer(JaxTrainerConfig(**common, enable_checkpointing=False, default_root_dir=str(tmp_path / "jax")),
               make_mesh(MeshConfig(data=1)), jax_tasks.clm_loss_fn(j_model, LATENTS), optax.adamw(2e-4),
               ).fit(lambda: params, batches, initial_params=params)
    Trainer(TrainerConfig(**common, default_root_dir=str(tmp_path / "port")), clm_loss_fn(t_model, LATENTS),
            make_optimizer(2e-4, optimizer="adamw"), model_config=config, device="cpu").fit(t_model, batches)

    def losses(root):
        return [(r["step"], r["train/loss"]) for r in map(json.loads, open(root / "metrics.jsonl"))
                if "train/loss" in r]

    got, want = losses(tmp_path / "port"), losses(tmp_path / "jax")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)


def test_model_for_config_and_pretrained_round_trip(pair, tmp_path):
    j_model, params, config, t_model = pair
    model = model_for_config(config, device="cpu", seed=4)
    assert type(model) is SymbolicAudioModel
    save_pretrained(str(tmp_path / "port"), t_model, config)
    state, loaded = load_pretrained(str(tmp_path / "port"))
    assert type(loaded) is SymbolicAudioModelConfig and loaded == config
    pipe = pipeline_from_pretrained("symbolic-audio-generation", str(tmp_path / "port"), device="cpu")
    assert isinstance(pipe, SymbolicAudioPipeline) and type(pipe.model) is SymbolicAudioModel
    jax_checkpoint.save_pretrained(str(tmp_path / "jax"), params, JaxSAMConfig(**KW))
    j_pipe = jax_pipelines.pipeline_from_pretrained("symbolic-audio-generation", str(tmp_path / "jax"))
    prompts = _prompts([12, 40], seed=5)
    call = dict(max_new_tokens=6, num_latents=4)
    for got, direct, want in zip(pipe(prompts, **call), SymbolicAudioPipeline(t_model, device="cpu")(prompts, **call),
                                 j_pipe(prompts, **call)):
        np.testing.assert_array_equal(got, direct)
        np.testing.assert_array_equal(got, np.asarray(want))

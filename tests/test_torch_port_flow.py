"""Optical flow in the port against the JAX package, on the CPU (mirrors
``tests/test_task_models.py`` ``TestOpticalFlow``,
``tests/test_data_vision.py``'s processor cases and
``tests/test_pipelines.py`` ``test_optical_flow_pipeline``).

- **Model**: the flow of the same seeded JAX weights carried over by
  ``convert/from_jax.py`` at fp32 atol/rtol 1e-5: JAX's test config (8 x 12
  image, 4 bands, 8 latents of 16 channels, 2 self-attends) and the
  published decoder's shape (one head of q/k = v = the latent width, no
  attention residual) through ``attention_impl="xla"``, and a config whose
  every attend JAX's Pallas kernel takes (128 pixels and latents, head dims
  of 32 and more) through ``"flash"`` against that kernel in interpret
  mode; the adapters' channels and defaults; the config round trip,
  ``model_for_config`` and the parameter count at the published width
  (41,057,134 in both packages).
- **Processor**: the grid, the 3 x 3 pixel features, the pyramid blend, the
  micro-batched ``process`` and ``render_optical_flow`` equal JAX's array
  for array.
- **Video**: a ``cv2`` write / read round trip (skipped where ``cv2`` does
  not import), read back as JAX's reader reads it.
- **Pipeline**: ``optical-flow`` flow and rendering equal JAX's pipeline at
  1e-5, one pair and a list; ``pipeline_from_pretrained`` serves a
  port-saved flow dir; the default device refuses the CPU.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.convert import hf_import as jax_hf
from perceiver_io_tpu.data import vision as jax_vision
from perceiver_io_tpu.data.vision import video as jax_video
from perceiver_io_tpu.inference import pipeline as jax_pipeline
from perceiver_io_tpu.models.core import config as jax_config
from perceiver_io_tpu.models.vision import optical_flow as jax_flow
from perceiver_io_tpu_torch.convert import hf_import
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.data import vision
from perceiver_io_tpu_torch.data.vision import video
from perceiver_io_tpu_torch.inference.pipelines import OpticalFlowPipeline, pipeline, pipeline_from_pretrained
from perceiver_io_tpu_torch.models import model_for_config
from perceiver_io_tpu_torch.models.core import config as port_config
from perceiver_io_tpu_torch.models.vision import optical_flow as flow
from perceiver_io_tpu_torch.training import checkpoint as port_checkpoint

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)
#: (encoder, decoder, latents) per config
CONFIGS = {
    # JAX's TestOpticalFlow
    "tiny": (dict(image_shape=(8, 12), num_patch_input_channels=27, num_patch_hidden_channels=16,
                  num_frequency_bands=4, num_cross_attention_heads=1, num_self_attention_heads=2,
                  num_self_attention_layers_per_block=2),
             dict(image_shape=(8, 12), num_cross_attention_heads=1),
             dict(num_latents=8, num_latent_channels=16)),
    # the published decoder: one head of q/k = v = the latents' width, no residual
    "published_decoder": (dict(image_shape=(8, 12), num_patch_hidden_channels=16, num_frequency_bands=4,
                               num_cross_attention_heads=1, num_self_attention_heads=2,
                               num_self_attention_layers_per_block=2),
                          dict(image_shape=(8, 12), num_cross_attention_heads=1, num_cross_attention_qk_channels=16,
                               num_cross_attention_v_channels=16, cross_attention_residual=False),
                          dict(num_latents=8, num_latent_channels=16)),
    # every attend one JAX's Pallas kernel takes: 128 pixels and latents,
    # head dims 34 (16 + 2 * (2 * 4 + 1)) and 32
    "flash": (dict(image_shape=(8, 16), num_patch_hidden_channels=16, num_frequency_bands=4,
                   num_cross_attention_heads=1, num_self_attention_heads=1, num_self_attention_layers_per_block=2),
              dict(image_shape=(8, 16), num_cross_attention_heads=1),
              dict(num_latents=128, num_latent_channels=32)),
    # JAX's test_optical_flow_pipeline: 8 x 8 patches
    "pipeline": (dict(image_shape=(8, 8), num_frequency_bands=4, num_cross_attention_heads=1,
                      num_self_attention_heads=2, num_self_attention_layers_per_block=1),
                 dict(image_shape=(8, 8), num_cross_attention_heads=1),
                 dict(num_latents=4, num_latent_channels=16)),
}
#: deepmind/optical-flow-perceiver as transformers.PerceiverConfig holds it
PUBLISHED = dict(train_size=[368, 496], d_model=322, d_latents=512, num_latents=2048, num_blocks=1,
                 num_self_attends_per_block=24, num_self_attention_heads=16, num_cross_attention_heads=1,
                 qk_channels=None, v_channels=None, cross_attention_widening_factor=1,
                 self_attention_widening_factor=1, attention_probs_dropout_prob=0.0, initializer_range=0.02,
                 hidden_act="gelu")
PUBLISHED_PARAMS = 41_057_134


def _configs(name):
    enc, dec, latents = CONFIGS[name]
    return (jax_config.PerceiverIOConfig(jax_flow.OpticalFlowEncoderConfig(**enc),
                                         jax_flow.OpticalFlowDecoderConfig(**dec), **latents),
            port_config.PerceiverIOConfig(flow.OpticalFlowEncoderConfig(**enc),
                                          flow.OpticalFlowDecoderConfig(**dec), **latents))


def _frames(rng, cfg, b=2):
    return rng.standard_normal((b, 2, 27, *cfg.encoder.image_shape)).astype(np.float32)


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
def models():
    """Per config: the JAX model, its seeded params (``eval_shape`` gives the
    tree without compiling ``init``) and the port's model carrying them."""
    out = {}
    for name in CONFIGS:
        jax_cfg, port_cfg = _configs(name)
        model = jax_flow.OpticalFlow(jax_cfg)
        shapes = jax.eval_shape(model.init, KEY, jnp.zeros((1, 2, 27, *jax_cfg.encoder.image_shape)))["params"]
        rng = np.random.default_rng(len(out))
        params = jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
        port = load_jax_params(flow.OpticalFlow(port_cfg, device="cpu", seed=1), params)
        out[name] = (model, params, port)
    return out


@pytest.mark.parametrize("name,impl", [("tiny", "xla"), ("published_decoder", "xla"), ("flash", "flash")])
def test_forward_matches_jax(models, rng, name, impl):
    model, params, port = models[name]
    x = _frames(rng, port.config)
    jax_model = jax_flow.OpticalFlow(model.config, attention_impl=impl)
    want = jax.jit(lambda p, x: jax_model.apply({"params": p}, x))(params, x)
    got = flow.OpticalFlow(port.config, attention_impl=impl, device="cpu")
    got.load_state_dict(port.state_dict())
    with torch.no_grad():
        out = got(torch.from_numpy(x))
    assert out.shape == (2, *port.config.encoder.image_shape, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_adapters_and_channel_defaults(models, rng):
    _, _, port = models["tiny"]
    adapter = port.encoder.input_adapter
    assert adapter.num_input_channels == 16 + 2 * (2 * 4 + 1)
    x = torch.from_numpy(_frames(rng, port.config))
    with torch.no_grad():
        out = adapter(x)
        # (b, 2, c, h, w) -> (b, h * w, 2 * c): frame 0's channels, then frame 1's
        stacked = x.permute(0, 3, 4, 1, 2).reshape(2, 96, 54)
        want = stacked @ adapter.linear.weight.T + adapter.linear.bias
        decoded = port.decoder.output_adapter(torch.ones(2, 96, adapter.num_input_channels))
    np.testing.assert_allclose(out[..., :16].numpy(), want.numpy(), **TOL)
    np.testing.assert_array_equal(out[0, :, 16:].numpy(), adapter.position_encoding(1)[0].numpy())
    cross = port.encoder.cross_attn_1.cross_attn.attention
    assert cross.q_proj.weight.shape[0] == cross.v_proj.weight.shape[0] == adapter.num_input_channels
    assert decoded.shape == (2, 8, 12, 2)
    assert port.decoder.output_query_provider is None


def test_config_round_trip_and_serves_from_pretrained(models, rng, tmp_path):
    jax_cfg, port_cfg = _configs("pipeline")
    assert port_config.config_to_dict(port_cfg) == jax_config.config_to_dict(jax_cfg)
    assert port_config.config_from_dict(None, jax_config.config_to_dict(jax_cfg)) == port_cfg
    _, _, port = models["pipeline"]
    port_checkpoint.save_pretrained(str(tmp_path), port, port_cfg)
    assert port_checkpoint.load_config(str(tmp_path)) == port_cfg
    assert isinstance(model_for_config(port_cfg, device="cpu"), flow.OpticalFlow)
    pair = tuple(rng.integers(0, 256, (10, 12, 3), dtype=np.uint8) for _ in range(2))
    kw = dict(patch_size=(8, 8), patch_min_overlap=2, batch_size=2)
    served = pipeline_from_pretrained("optical-flow", str(tmp_path), device="cpu", **kw)
    assert isinstance(served, OpticalFlowPipeline) and served.device == torch.device("cpu")
    np.testing.assert_array_equal(served(pair), pipeline("optical-flow", port, device="cpu", **kw)(pair))


def test_published_width_parameter_count():
    """deepmind/optical-flow-perceiver through both packages'
    ``optical_flow_config_from_hf``: 368 x 496 patches, 2048 x 512 latents,
    24 self-attends of 16 heads, one cross head at (322, 322), the decoder's
    one head at (512, 512)."""
    hf = types.SimpleNamespace(**PUBLISHED)
    jax_cfg, port_cfg = jax_hf.optical_flow_config_from_hf(hf), hf_import.optical_flow_config_from_hf(hf)
    assert port_config.config_to_dict(port_cfg) == jax_config.config_to_dict(jax_cfg)
    shapes = jax.eval_shape(jax_flow.OpticalFlow(jax_cfg).init, KEY, jnp.zeros((1, 2, 27, 368, 496)))
    port = flow.OpticalFlow(port_cfg, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == PUBLISHED_PARAMS
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)) == PUBLISHED_PARAMS
    cross = port.decoder.cross_attn.cross_attn.attention
    assert (cross.q_proj.weight.shape[0], cross.v_proj.weight.shape[0]) == (512, 512)
    assert not port.decoder.cross_attn.attention_residual


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_mma_plan_at_the_flow_attends(dtype):
    """K1 ``wide_mma``'s plan at the published width's two cross attends,
    both past 272 columns (the column split: 16-row tiles, the 8 warps over
    the output's columns): 3 key splits of the encoder's 2852 key tiles (128
    row tiles x 3 = 384 blocks a batch row), one over the decoder's 32 (11408
    row tiles); every key tile in one split; the fp32 partials at the
    pipeline's b = 2 within 1 GB, and every tensor's elements a batch row
    below 2**31 (the kernel's offsets past the batch row are 64-bit)."""
    from perceiver_io_tpu_torch.ops import flash_attention as fa

    for (i, j, d, dv), (splits, per) in (((2048, 182528, 322, 322), (3, 951)), ((182528, 2048, 512, 512), (1, 32))):
        plan = fa._wide_mma_fwd_plan(i, j, 1, d, dv, dtype)
        assert (plan.rows, plan.keys, plan.col_blocks, plan.fused) == (16, 64, 1, False)
        assert (plan.splits, plan.tiles_per_split) == (splits, per)
        tiles = -(-j // plan.keys)
        assert (splits - 1) * per < tiles <= splits * per
        assert fa._wide_mma_columns(dv, plan.col_blocks) == ((0, dv),)
        partial_bytes = 2 * plan.splits * i * (dv + 2) * 4
        assert partial_bytes < 2**30
        assert max(i * d, j * d, j * dv, i * dv, plan.splits * i * dv) < 2**31


# -- the processor (tests/test_data_vision.py) ---------------------------------------


@pytest.mark.parametrize("image,patch,overlap", [((20, 14), (8, 8), 2), ((16, 16), (8, 8), 0),
                                                 ((436, 1024), (368, 496), 20), ((12, 12), (8, 8), 4)])
def test_grid_indices_match_jax(image, patch, overlap):
    got = vision.OpticalFlowProcessor(patch_size=patch, patch_min_overlap=overlap).grid_indices(image)
    assert got == jax_vision.OpticalFlowProcessor(patch_size=patch, patch_min_overlap=overlap).grid_indices(image)
    assert len(set(got)) == len(got)
    with pytest.raises(ValueError, match="must be smaller"):
        vision.OpticalFlowProcessor(patch_size=patch, patch_min_overlap=min(patch))


def test_preprocess_postprocess_and_process_match_jax(rng):
    proc = vision.OpticalFlowProcessor(patch_size=(8, 8), patch_min_overlap=2)
    jax_proc = jax_vision.OpticalFlowProcessor(patch_size=(8, 8), patch_min_overlap=2)
    img = rng.standard_normal((3, 10, 12)).astype(np.float32)
    np.testing.assert_array_equal(proc._pixel_features(img), jax_proc._pixel_features(img))
    pairs = [tuple(rng.integers(0, 256, (12, 14, 3), dtype=np.uint8) for _ in range(2)) for _ in range(2)]
    np.testing.assert_array_equal(proc.preprocess(pairs[0]), jax_proc.preprocess(pairs[0]))
    gray = tuple(rng.integers(0, 256, (12, 14), dtype=np.uint8) for _ in range(2))
    np.testing.assert_array_equal(proc.preprocess(gray), jax_proc.preprocess(gray))
    np.testing.assert_array_equal(proc.preprocess_batch(pairs), jax_proc.preprocess_batch(pairs))
    preds = rng.standard_normal((2, len(proc.grid_indices((12, 14))), 8, 8, 2)).astype(np.float32)
    np.testing.assert_array_equal(proc.postprocess(preds, (12, 14)), jax_proc.postprocess(preds, (12, 14)))
    np.testing.assert_array_equal(proc.postprocess(preds[0], (12, 14)), jax_proc.postprocess(preds[0], (12, 14)))
    with pytest.raises(ValueError, match="patches, grid expects"):
        proc.postprocess(preds[:, :1], (12, 14))

    def model_fn(x):  # a deterministic stand-in: each patch's mean feature per pixel, two channels
        m = x.mean(axis=(1, 2))[..., None]
        return np.concatenate([m, -2 * m], axis=-1)

    shapes = []
    got = proc.process(lambda x: shapes.append(x.shape) or model_fn(x), pairs, batch_size=3)
    np.testing.assert_array_equal(got, jax_proc.process(model_fn, pairs, batch_size=3))
    assert got.shape == (2, 12, 14, 2) and {s[0] for s in shapes} == {3}  # the last micro-batch padded


def test_render_matches_jax(rng):
    f = (rng.standard_normal((9, 11, 2)) * 10).astype(np.float32)
    f[0, 0] = 0.0
    f[1, 1] = (24.0, 0.0)
    got = vision.render_optical_flow(f)
    assert got.dtype == np.uint8 and got.shape == (9, 11, 3)
    np.testing.assert_array_equal(got, jax_vision.render_optical_flow(f))
    assert (got[0, 0] == 255).all() and got[1, 1, 0] > 200 and got[1, 1, 1] < 60


def test_video_round_trip(rng, tmp_path):
    pytest.importorskip("cv2")
    frames = [np.full((16, 24, 3), 40 * k, np.uint8) + rng.integers(0, 8, (16, 24, 3), dtype=np.uint8)
              for k in range(4)]
    path = tmp_path / "clip.mp4"
    video.write_video(path, frames, fps=10)
    got = video.read_video_frames(path)
    assert len(got) == 4 and got[0].shape == (16, 24, 3) and got[0].dtype == np.uint8
    assert max(np.abs(g.astype(int) - f.astype(int)).mean() for g, f in zip(got, frames)) < 8  # lossy codec
    want = jax_video.read_video_frames(path, max_frames=3)
    assert len(want) == 3
    for g, w in zip(video.read_video_frames(path, max_frames=3), want):
        np.testing.assert_array_equal(g, w)
    pairs = list(video.frame_pairs(got))
    assert len(pairs) == 3 and pairs[1][0] is got[1] and pairs[1][1] is got[2]
    with pytest.raises(ValueError, match="no frames"):
        video.write_video(tmp_path / "empty.mp4", [])


# -- the pipeline (tests/test_pipelines.py) ------------------------------------------


def test_optical_flow_pipeline_matches_jax(models, rng):
    model, params, port = models["pipeline"]
    kw = dict(patch_size=(8, 8), patch_min_overlap=2, batch_size=2)
    pairs = [tuple(rng.integers(0, 256, (10, 12, 3), dtype=np.uint8) for _ in range(2)) for _ in range(3)]
    got = pipeline("optical-flow", port, device="cpu", **kw)
    want = jax_pipeline("optical-flow", model, params, **kw)
    single = got(pairs[0])
    assert single.shape == (10, 12, 2)
    np.testing.assert_allclose(single, want(pairs[0]), **TOL)
    batch = got(pairs)
    assert batch.shape == (3, 10, 12, 2)
    np.testing.assert_allclose(batch, want(pairs), **TOL)
    rendered = pipeline("optical-flow", port, device="cpu", render=True, **kw)(pairs)
    assert rendered.shape == (3, 10, 12, 3) and rendered.dtype == np.uint8
    np.testing.assert_array_equal(rendered, np.stack([vision.render_optical_flow(f) for f in batch]))


@pytest.mark.parametrize("entry", ["model", "pipeline"])
def test_default_device_refuses_the_cpu(models, entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, port_cfg = _configs("pipeline")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "model":
            flow.OpticalFlow(port_cfg)
        else:
            pipeline("optical-flow", models["pipeline"][2])

"""The port's training parallelism against the JAX package's, on the CPU.

- **Specs** (no ranks): ``infer_param_specs`` on the port's model of every
  family equals JAX's spec of every leaf through the converter's names and
  transposes, at ``data=2, model=4``, ``fsdp=8`` and ``data=2, fsdp=2,
  model=2``; ``serving_state_specs`` and ``batch_spec`` equal JAX's.
- **Trajectories**: a tiny CLM (JAX's ``tiny_clm``) trained 3 Adam steps
  in a world of 2 ranks (``data=2``, ``fsdp=2``, ``model=2``, ``seq=2``
  with ``shard_seq`` and ring attention, ``grad_accum_steps=4`` x
  ``data=2``, ``multi_steps=2`` x ``data=2``) and of 4 (``data=2,
  model=2``, ``fsdp=2, model=2``) against JAX's single-device baseline at
  rtol 2e-4, over batches whose masks differ between the ranks; the MLM and
  the image classifier at ``data=2`` and ``model=2``; a world of one equals
  the no-mesh step to the bit; a ``data=2`` fit with prefix dropout equals
  the port's own unsharded one (each rank keeps its rows of the draw).
- **LAMB** over sharded parameters (``fsdp=2``, ``model=2``, ``fsdp=2,
  model=2``: whole norms from one all-reduce a tuple of sharded axes)
  against JAX's single-device ``optax.lamb`` at rtol 2e-4; a world of one
  with LAMB equals the no-mesh LAMB step to the bit.
- **Fused q/k/v** (``PERCEIVER_FUSED_QKV=1``) at ``model=2``: each rank's
  one product over its column shards, against JAX's single-device
  trajectory at rtol 2e-4.
- **Layout**: after an ``fsdp=2`` step a sharded parameter's shard and its
  Adam moments hold half its rows or columns; the MLM's tied embedding
  shards.
- **Collectives** (the port's counters): ``data=2`` all-reduces the
  gradient bytes once a step, ``fsdp=2`` all-gathers and reduce-scatters,
  ``model=2`` all-reduces after each row-parallel product.

Rank processes: ``tests/_torch_port_parallel_worker.py``, one world per
size for the module, one intra-op thread each.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_parallel import CLM_KW, LATENTS, PREFIX, SEQ, TRAJ_RTOL, clm_batches, jax_trajectory, run_world
from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModel as JaxSAM
from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModelConfig as JaxSAMConfig
from perceiver_io_tpu.models.core import config as jax_config
from perceiver_io_tpu.models.text import classifier as jax_classifier
from perceiver_io_tpu.models.text import common as jax_common
from perceiver_io_tpu.models.text import mlm as jax_mlm
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.models.vision import image_classifier as jax_image
from perceiver_io_tpu.models.vision import optical_flow as jax_flow
from perceiver_io_tpu.parallel import MeshConfig as JaxMeshConfig
from perceiver_io_tpu.parallel import make_mesh as jax_make_mesh
from perceiver_io_tpu.parallel import partition as jax_partition
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu_torch.convert.from_jax import state_dict_from_jax, torch_name
from perceiver_io_tpu_torch.models import model_for_config
from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModelConfig
from perceiver_io_tpu_torch.models.core import config as port_config
from perceiver_io_tpu_torch.models.text import common
from perceiver_io_tpu_torch.models.text import mlm
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModelConfig
from perceiver_io_tpu_torch.models.vision import image_classifier as image
from perceiver_io_tpu_torch.models.vision import optical_flow as flow
from perceiver_io_tpu_torch.parallel import (MeshConfig, TrainState, collectives, create_train_state, make_mesh,
                                             make_train_step, multihost, partition, shard_batch)
from perceiver_io_tpu_torch.training import clm_loss_fn, make_optimizer

KEY = jax.random.PRNGKey(0)
CLM_BUILD = ("perceiver_io_tpu_torch.models.text.clm", "CausalLanguageModel")
MESHES = {"dp2xtp4": dict(data=2, model=4), "fsdp8": dict(data=1, fsdp=8),
          "dp2xfsdp2xtp2": dict(data=2, fsdp=2, model=2)}

# JAX's tests/test_parallel_families.py models
MLM_ENC = dict(vocab_size=32, max_seq_len=SEQ, num_input_channels=32, num_cross_attention_heads=2,
               num_self_attention_heads=2, num_self_attention_layers_per_block=2)
MLM_DEC = dict(vocab_size=32, max_seq_len=SEQ)
MLM_LAT = dict(num_latents=8, num_latent_channels=32)
IMG_ENC = dict(image_shape=(8, 8, 1), num_frequency_bands=4, num_cross_attention_heads=1,
               num_self_attention_heads=2, num_self_attention_layers_per_block=2)
IMG_DEC = dict(num_classes=10, num_output_query_channels=16, num_cross_attention_heads=2)
IMG_LAT = dict(num_latents=4, num_latent_channels=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _families():
    """name -> (JAX model, JAX init args, port config)."""
    ids = jnp.zeros((1, SEQ), jnp.int32)
    sam = dict(max_seq_len=96, max_latents=32, num_channels=64, num_heads=2, num_self_attention_layers=2)
    clf_enc = dict(vocab_size=262, max_seq_len=SEQ, num_input_channels=16, num_cross_attention_heads=2,
                   num_self_attention_heads=2, num_self_attention_layers_per_block=2)
    clf_dec = dict(num_output_query_channels=12, num_cross_attention_heads=2, num_classes=2)
    flow_enc = dict(image_shape=(8, 12), num_patch_input_channels=27, num_patch_hidden_channels=16,
                    num_frequency_bands=4, num_cross_attention_heads=1, num_self_attention_heads=2,
                    num_self_attention_layers_per_block=2)
    flow_dec = dict(image_shape=(8, 12), num_cross_attention_heads=1)
    lat = dict(num_latents=8, num_latent_channels=16)
    return {
        "clm": (JaxCLM(JaxCLMConfig(**CLM_KW)), (ids, PREFIX), CausalLanguageModelConfig(**CLM_KW)),
        "mlm": (jax_mlm.MaskedLanguageModel(jax_config.PerceiverIOConfig(
                    jax_common.TextEncoderConfig(**MLM_ENC), jax_mlm.TextDecoderConfig(**MLM_DEC), **MLM_LAT)),
                (ids,), port_config.PerceiverIOConfig(common.TextEncoderConfig(**MLM_ENC),
                                                       mlm.TextDecoderConfig(**MLM_DEC), **MLM_LAT)),
        "text_classifier": (jax_classifier.TextClassifier(jax_config.PerceiverIOConfig(
                                jax_common.TextEncoderConfig(**clf_enc),
                                jax_config.ClassificationDecoderConfig(**clf_dec), **lat)),
                            (ids,), port_config.PerceiverIOConfig(common.TextEncoderConfig(**clf_enc),
                                                                   port_config.ClassificationDecoderConfig(**clf_dec),
                                                                   **lat)),
        "image_classifier": (jax_image.ImageClassifier(jax_config.PerceiverIOConfig(
                                 jax_image.ImageEncoderConfig(**IMG_ENC),
                                 jax_config.ClassificationDecoderConfig(**IMG_DEC), **IMG_LAT)),
                             (jnp.zeros((1, 8, 8, 1)),),
                             port_config.PerceiverIOConfig(image.ImageEncoderConfig(**IMG_ENC),
                                                           port_config.ClassificationDecoderConfig(**IMG_DEC),
                                                           **IMG_LAT)),
        "optical_flow": (jax_flow.OpticalFlow(jax_config.PerceiverIOConfig(
                             jax_flow.OpticalFlowEncoderConfig(**flow_enc),
                             jax_flow.OpticalFlowDecoderConfig(**flow_dec), **lat)),
                         (jnp.zeros((1, 2, 27, 8, 12)),),
                         port_config.PerceiverIOConfig(flow.OpticalFlowEncoderConfig(**flow_enc),
                                                       flow.OpticalFlowDecoderConfig(**flow_dec), **lat)),
        "symbolic_audio": (JaxSAM(JaxSAMConfig(**sam)), (jnp.zeros((1, 96), jnp.int32), 64),
                           SymbolicAudioModelConfig(**sam)),
    }


FAMILIES = _families()


@functools.lru_cache(maxsize=None)
def _family_shapes(name):
    j_model, args, port_cfg = FAMILIES[name]
    shapes = jax.eval_shape(lambda: j_model.init(KEY, *args))["params"]
    return shapes, model_for_config(port_cfg, device="cpu")


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_specs_match_jax(family, mesh):
    """Every leaf, through the converter's names and transposes, at the
    production FSDP threshold and at 0 (every leaf eligible)."""
    shapes, port_model = _family_shapes(family)
    jax_mesh = jax_make_mesh(JaxMeshConfig(**MESHES[mesh]))
    for min_fsdp in (0, 2**14):
        j_specs = jax_partition.infer_param_specs(shapes, jax_mesh, min_fsdp_size=min_fsdp)
        leaves = jax.tree_util.tree_flatten_with_path(j_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        shape_of = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
        p_specs = partition.infer_param_specs(port_model, MeshConfig(**MESHES[mesh]), min_fsdp_size=min_fsdp)
        seen = set()
        for kp, spec in leaves:
            path = "/".join(str(getattr(k, "key", k)) for k in kp)
            ndim = len(shape_of[kp].shape)
            want = _padded(spec, ndim)
            name = torch_name(path)
            if path.endswith("kernel"):
                want = want[::-1]
            assert _padded(p_specs[name], ndim) == want, (family, mesh, min_fsdp, path)
            seen.add(name)
        assert seen == set(p_specs), (family, sorted(set(p_specs) ^ seen))


def _slot_state():
    """A slot state's leaves by name, as the slot engine's paged and dense
    layouts hold them (slots 4, heads 4, 8-token pages)."""
    return {
        "pool_k": np.zeros((64, 4, 16)), "pool_v": np.zeros((64, 4, 16)),
        "scale_k": np.zeros((64, 4, 1)), "scale_v": np.zeros((64, 4, 1)),
        "stage_k": np.zeros((1, 4, 32, 16)), "stage_v": np.zeros((1, 4, 32, 16)),
        "cross_k": np.zeros((4, 4, 24, 16)), "cross_v": np.zeros((4, 4, 24, 16)),
        "stack_k": (np.zeros((4, 4, 8, 16)), np.zeros((4, 4, 8, 16))),
        "stack_v": (np.zeros((4, 4, 8, 16)), np.zeros((4, 4, 8, 16))),
        "window": np.zeros((4, 32)), "logits": np.zeros((4, 262)), "table": np.zeros((4, 8)),
        "pad": np.zeros(4), "length": np.zeros(4), "m": np.zeros(4), "steps": np.zeros(4),
        "tokens": np.zeros(4), "other": np.zeros((4, 4)), "heads3": np.zeros((3, 3, 8, 16)),
    }


@pytest.mark.parametrize("mesh", [dict(data=2, model=4), dict(data=4, model=2), dict(data=8)])
def test_serving_state_and_batch_specs_match_jax(mesh):
    jax_mesh = jax_make_mesh(JaxMeshConfig(**mesh))
    state = _slot_state()
    j_specs = jax_partition.serving_state_specs(state, jax_mesh)
    flat = jax.tree_util.tree_flatten_with_path(j_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    p_specs = partition.serving_state_specs(state, MeshConfig(**mesh))
    assert len(flat) == len(p_specs)
    for kp, spec in flat:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        assert tuple(p_specs[path]) == tuple(spec), path
    for ndim in (1, 2, 3, 4):
        for shard_seq in (False, True):
            for stacked in (False, True):
                if stacked and ndim < 2:
                    continue
                kw = dict(ndim=ndim, shard_seq=shard_seq, stacked_steps=stacked)
                for seq_mesh in (mesh, {**mesh, "seq": 1}, {"data": 1, "seq": 2}):
                    jm = jax_make_mesh(JaxMeshConfig(**seq_mesh))
                    assert tuple(partition.batch_spec(MeshConfig(**seq_mesh), **kw)) == \
                        tuple(jax_partition.batch_spec(jm, **kw)), (seq_mesh, kw)


# -- trajectories -------------------------------------------------------------

def _seeded_params(module, *args, seed=0):
    """``module``'s JAX param tree drawn from a seeded numpy generator
    (``eval_shape`` gives the tree without compiling ``init``)."""
    shapes = jax.eval_shape(lambda: module.init(KEY, *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)


@functools.lru_cache(maxsize=1)
def _clm_pair():
    j_model = JaxCLM(JaxCLMConfig(**CLM_KW))
    return j_model, _seeded_params(j_model, jnp.zeros((1, SEQ), jnp.int32), PREFIX)


def _mlm_pair():
    j_model = jax_mlm.MaskedLanguageModel(jax_config.PerceiverIOConfig(
        jax_common.TextEncoderConfig(**MLM_ENC), jax_mlm.TextDecoderConfig(**MLM_DEC), **MLM_LAT))
    params = _seeded_params(j_model, jnp.zeros((1, SEQ), jnp.int32), seed=1)
    cfg = port_config.PerceiverIOConfig(common.TextEncoderConfig(**MLM_ENC), mlm.TextDecoderConfig(**MLM_DEC),
                                        **MLM_LAT)
    return j_model, params, ("perceiver_io_tpu_torch.models.text.mlm", "MaskedLanguageModel", cfg, {})


def _img_pair():
    j_model = jax_image.ImageClassifier(jax_config.PerceiverIOConfig(
        jax_image.ImageEncoderConfig(**IMG_ENC), jax_config.ClassificationDecoderConfig(**IMG_DEC), **IMG_LAT))
    params = _seeded_params(j_model, jnp.zeros((1, 8, 8, 1)), seed=2)
    cfg = port_config.PerceiverIOConfig(image.ImageEncoderConfig(**IMG_ENC),
                                        port_config.ClassificationDecoderConfig(**IMG_DEC), **IMG_LAT)
    return j_model, params, ("perceiver_io_tpu_torch.models.vision.image_classifier", "ImageClassifier", cfg, {})


def _mlm_batches(n=3, seed=1):
    """Labels on every third position of rows 0-3 and every second of rows
    4-7: the two ranks of ``data=2`` hold unequal label counts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 32, size=(8, SEQ)).astype(np.int64)
        every = np.where(np.arange(8) < 4, 3, 2)[:, None]
        labels = np.where(np.arange(SEQ)[None, :] % every == 0, ids, -100)
        out.append({"input_ids": ids, "labels": labels})
    return out


def _img_batches(n=3, seed=2):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(8, 8, 8, 1)).astype(np.float32),
             "label": rng.integers(0, 10, size=(8,)).astype(np.int64)} for _ in range(n)]


def _clm_build(impl="auto", **rates):
    return (*CLM_BUILD, CausalLanguageModelConfig(**{**CLM_KW, **rates}), {"attention_impl": impl})


CLM_LAYOUT = ("perceiver_ar.input_adapter.txt_embedding.weight",
              "perceiver_ar.self_attention.layers.0.self_attn.attention.q_proj.weight",
              "perceiver_ar.self_attention.layers.0.mlp.out.weight")


@pytest.fixture(scope="module")
def jax_baselines():
    j_model, params = _clm_pair()
    batches = clm_batches()
    loss = jax_tasks.clm_loss_fn(j_model, LATENTS)
    mj, mparams, _ = _mlm_pair()
    ij, iparams, _ = _img_pair()
    return {
        # JAX's multi_steps=2 is two of these steps in one program (no noise)
        "clm": jax_trajectory(j_model, params, loss, batches),
        "clm_accum4": jax_trajectory(j_model, params, loss, batches, accum=4),
        "mlm": jax_trajectory(mj, mparams, jax_tasks.mlm_loss_fn(mj), _mlm_batches()),
        "img": jax_trajectory(ij, iparams, jax_tasks.image_classifier_loss_fn(ij), _img_batches()),
        "clm_lamb": jax_trajectory(j_model, params, loss, batches, optimizer="lamb"),
    }


def _clm_case(mesh, **kw):
    _, params = _clm_pair()
    args = dict(build=_clm_build(kw.pop("impl", "auto")), state_dict=state_dict_from_jax(params),
                loss=("clm_loss_fn", (LATENTS,)), batches=clm_batches(), mesh=mesh)
    args.update(kw)
    return args


def _family_case(pair, loss, batches, mesh, **kw):
    _, params, build = pair()
    return dict(build=build, state_dict=state_dict_from_jax(params), loss=(loss, ()), batches=batches,
                mesh=mesh, **kw)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = [
        ("data2", "trajectory", _clm_case(dict(data=2))),
        ("fsdp2", "trajectory", _clm_case(dict(data=1, fsdp=2), layout=CLM_LAYOUT)),
        ("model2", "trajectory", _clm_case(dict(data=1, model=2))),
        ("seq2", "trajectory", _clm_case(dict(data=1, seq=2), shard_seq=True, impl="ring")),
        ("accum4_data2", "trajectory", _clm_case(dict(data=2), accum=4)),
        ("multi2_data2", "trajectory", _clm_case(dict(data=2), multi=2)),
        ("dropout_none", "trajectory", _clm_case(None, build=_clm_build(cross_attention_dropout=0.5),
                                                 generators=True)),
        ("dropout_data2", "trajectory", _clm_case(dict(data=2), build=_clm_build(cross_attention_dropout=0.5),
                                                  generators=True)),
        ("mlm_data2", "trajectory", _family_case(_mlm_pair, "mlm_loss_fn", _mlm_batches(), dict(data=2))),
        ("mlm_model2", "trajectory", _family_case(_mlm_pair, "mlm_loss_fn", _mlm_batches(), dict(data=1, model=2))),
        ("mlm_fsdp2", "trajectory", _family_case(
            _mlm_pair, "mlm_loss_fn", _mlm_batches()[:1], dict(data=1, fsdp=2),
            layout=("encoder.input_adapter.txt_embedding.weight", "decoder.output_query_provider.query",
                    "encoder.latent_provider.query"))),
        ("img_data2", "trajectory", _family_case(_img_pair, "image_classifier_loss_fn", _img_batches(), dict(data=2))),
        ("img_model2", "trajectory", _family_case(_img_pair, "image_classifier_loss_fn", _img_batches(),
                                                  dict(data=1, model=2))),
        ("outside", "outside_mesh", {}),
        ("lamb_fsdp2", "trajectory", _clm_case(dict(data=1, fsdp=2), optimizer="lamb", layout=CLM_LAYOUT)),
        ("lamb_model2", "trajectory", _clm_case(dict(data=1, model=2), optimizer="lamb")),
        ("fused_model2", "trajectory", _clm_case(dict(data=1, model=2), env={"PERCEIVER_FUSED_QKV": "1"})),
    ]
    return run_world(tmp_path_factory.mktemp("parallel"), 2, cases)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [
        ("data2_model2", "trajectory", _clm_case(dict(data=2, model=2))),
        ("fsdp2_model2", "trajectory", _clm_case(dict(data=1, fsdp=2, model=2))),
        ("lamb_fsdp2_model2", "trajectory", _clm_case(dict(data=1, fsdp=2, model=2), optimizer="lamb")),
    ]
    return run_world(tmp_path_factory.mktemp("parallel"), 4, cases)


@pytest.mark.parametrize("case", ["data2", "fsdp2", "model2", "seq2"])
def test_clm_sharded_matches_jax_single_device(world2, jax_baselines, case):
    for rank in world2:  # every rank reports the global loss
        np.testing.assert_allclose(rank[case]["losses"], jax_baselines["clm"], rtol=TRAJ_RTOL)


@pytest.mark.parametrize("case", ["data2_model2", "fsdp2_model2"])
def test_clm_composed_meshes_match_jax(world4, jax_baselines, case):
    for rank in world4:
        np.testing.assert_allclose(rank[case]["losses"], jax_baselines["clm"], rtol=TRAJ_RTOL)


@pytest.mark.parametrize("world,case", [("world2", "lamb_fsdp2"), ("world2", "lamb_model2"),
                                        ("world4", "lamb_fsdp2_model2")])
def test_lamb_sharded_matches_jax_single_device(request, jax_baselines, world, case):
    """The trust ratio's norms are the whole tensors' (summed over the
    shards), so every rank's losses follow JAX's single-device LAMB."""
    ranks = request.getfixturevalue(world)
    for rank in ranks:
        np.testing.assert_allclose(rank[case]["losses"], jax_baselines["clm_lamb"], rtol=TRAJ_RTOL)
        assert rank[case]["losses"] == ranks[0][case]["losses"]
    # the norms take one all-reduce per tuple of sharded axes a step, not one per parameter
    lamb = ranks[0][case]["counts"][1]["all_reduce"]
    adam = ranks[0][case.replace("lamb_", "")]["counts"][1]["all_reduce"]
    assert lamb["calls"] - adam["calls"] == (2 if world == "world4" else 1), (lamb, adam)


def test_lamb_fsdp_shards_its_moments(world2):
    for rank in world2:
        for name, lay in rank["lamb_fsdp2"]["layout"].items():
            assert lay["param"] == lay["exp_avg"] == lay["exp_avg_sq"] != lay["full"], name


def test_fused_qkv_model2_matches_jax_single_device(world2, jax_baselines):
    """Each tensor-parallel rank projects its heads' q, k and v in one
    product over its column shards (split at the local widths)."""
    for rank in world2:
        np.testing.assert_allclose(rank["fused_model2"]["losses"], jax_baselines["clm"], rtol=TRAJ_RTOL)


@pytest.mark.parametrize("case,baseline", [("accum4_data2", "clm_accum4"), ("multi2_data2", "clm")])
def test_accumulation_and_multi_steps_match_jax(world2, jax_baselines, case, baseline):
    """Microbatch i is global rows [i·n/4, (i+1)·n/4): with the label counts
    differing between rows, grouping each rank's own rows would not match.
    ``multi_steps=2`` runs two steps a call, JAX's plain steps' losses."""
    np.testing.assert_allclose(world2[0][case]["losses"], jax_baselines[baseline], rtol=TRAJ_RTOL)


@pytest.mark.parametrize("case,baseline", [("mlm_data2", "mlm"), ("mlm_model2", "mlm"),
                                           ("img_data2", "img"), ("img_model2", "img")])
def test_families_sharded_match_jax(world2, jax_baselines, case, baseline):
    np.testing.assert_allclose(world2[0][case]["losses"], jax_baselines[baseline], rtol=TRAJ_RTOL)


def test_dropout_data2_takes_each_ranks_rows_of_the_draw(world2):
    """Prefix dropout 0.5 from the step generators: ``data=2`` gives the
    unsharded run's losses and weights (a rank drawing only its own rows
    would drop other prefix positions)."""
    ref = world2[0]["dropout_none"]
    for rank in world2:
        np.testing.assert_allclose(rank["dropout_data2"]["losses"], ref["losses"], rtol=TRAJ_RTOL)
    for name, value in ref["params"].items():
        np.testing.assert_allclose(world2[0]["dropout_data2"]["params"][name], value, atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_fsdp_shards_params_and_adam_moments(world2):
    for rank in world2:
        for name, lay in rank["fsdp2"]["layout"].items():
            dim = lay["spec"].index("fsdp")
            want = list(lay["full"])
            want[dim] //= 2
            assert lay["param"] == tuple(want) == lay["exp_avg"] == lay["exp_avg_sq"], name
    # the MLM's tied embedding and both query arrays shard too
    for name, lay in world2[0]["mlm_fsdp2"]["layout"].items():
        assert "fsdp" in lay["spec"] and lay["param"] != lay["full"] and lay["exp_avg"] == lay["param"], name


def test_collectives_by_mesh(world2):
    """The intent of JAX's ``test_scaling_costs.py``, from the port's
    counters (the step after the first)."""
    n_params = sum(np.asarray(v).size for v in world2[0]["data2"]["params"].values())
    data2 = world2[0]["data2"]["counts"][1]
    # one all-reduce of every gradient byte (fp32), the loss and count scalars besides
    assert data2["all_gather"]["calls"] == data2["reduce_scatter"]["calls"] == 0
    assert 4 * n_params <= data2["all_reduce"]["bytes"] <= 4 * n_params + 64
    fsdp2 = world2[0]["fsdp2"]["counts"][1]
    assert fsdp2["all_gather"]["calls"] > 0 and fsdp2["reduce_scatter"]["calls"] == fsdp2["all_gather"]["calls"]
    # each rank puts in half of every parameter, and takes back half of each gradient
    assert fsdp2["all_gather"]["bytes"] * 2 == fsdp2["reduce_scatter"]["bytes"] == 4 * n_params
    model2 = world2[0]["model2"]["counts"][1]
    # 3 layers: a row-parallel all-reduce after o and after the MLM's out in
    # the forward, and the column-parallel inputs' gradient all-reduces
    assert model2["all_reduce"]["calls"] >= 3 * 2 * 2 and model2["all_gather"]["calls"] == 0
    seq2 = world2[0]["seq2"]["counts"][1]
    assert seq2["send_recv"]["calls"] > 0 and seq2["send_recv"]["host_staged"] == 0


def test_rank_outside_a_smaller_mesh_raises(world2):
    assert world2[0]["outside"] == dict(ranks=[0], error=None)
    assert world2[1]["outside"]["ranks"] == [0] and "outside the mesh" in world2[1]["outside"]["error"]


def test_world_of_one_equals_the_unsharded_step_bitwise(tmp_path):
    """In this process: a gloo world of one, the mesh ``data=1``; losses and
    parameters after 3 steps equal the no-mesh step's to the bit."""
    _world_of_one_bitwise(tmp_path, "adam")


def test_world_of_one_with_lamb_equals_the_unsharded_lamb_bitwise(tmp_path):
    """As above with LAMB: nothing is sharded, so no norm reducer is
    attached and the trust ratios are the local norms'."""
    _world_of_one_bitwise(tmp_path, "lamb")


def _world_of_one_bitwise(tmp_path, optimizer):
    j_model, params = _clm_pair()
    sd = state_dict_from_jax(params)

    def run(mesh):
        from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel

        model = CausalLanguageModel(CausalLanguageModelConfig(**CLM_KW), device="cpu")
        model.load_state_dict(sd)
        tx = make_optimizer(1e-2, optimizer=optimizer)
        state = TrainState.create(model, tx) if mesh is None else create_train_state(model, tx, mesh)[0]
        assert getattr(state.optimizer, "norm_reducer", None) is None
        step = make_train_step(clm_loss_fn(model, LATENTS), grad_clip_norm=1.0, mesh=mesh, device="cpu")
        losses = []
        for b in clm_batches():
            state, m = step(state, b if mesh is None else shard_batch(b, mesh), None)
            losses.append(m["loss"].item())
        return losses, {k: v.clone() for k, v in state.model_state_dict().items()}

    base_losses, base_params = run(None)
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        mesh = make_mesh(MeshConfig(data=1), device="cpu")
        collectives.reset_counts()
        losses, params_after = run(mesh)
        assert all(v["calls"] == 0 for v in collectives.read_counts().values())
    finally:
        multihost.shutdown()
    assert losses == base_losses
    for name, value in base_params.items():
        assert torch.equal(params_after[name], value), name

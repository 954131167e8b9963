"""Port model against the JAX package, on the CPU: the weight bridge, CLM
logits (with and without left padding), and the logits of the three decode
phases' steps. One tiny config (vocab 64, max_seq_len 12, max_latents 6,
16 channels, 2 heads, 2 layers); JAX weights from a seed go through
``convert.from_jax`` into the port. fp32, atol/rtol 1e-5 (same arithmetic,
different summation order).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.inference import generate as gen
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig

# the package re-exports the generate() function under the module's name
jax_gen = importlib.import_module("perceiver_io_tpu.inference.generate")

TOL = dict(atol=1e-5, rtol=1e-5)
KW = dict(vocab_size=64, max_seq_len=12, max_latents=6, num_channels=16, num_heads=2,
          num_self_attention_layers=2, init_scale=0.1)


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
    j_model = JaxCLM(config=JaxConfig(**KW))
    params = jax.jit(j_model.init, static_argnames="prefix_len")(
        jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32), prefix_len=6
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**KW), device="cpu", seed=1)
    load_jax_params(t_model, params)
    return j_model, params, t_model.eval()


def test_weight_bridge_maps_every_parameter(pair):
    _, params, t_model = pair
    sd = state_dict_from_jax({"params": params})
    assert set(sd) == set(t_model.state_dict())
    ca = params["perceiver_ar"]["cross_attention"]["cross_attn"]
    np.testing.assert_array_equal(
        sd["perceiver_ar.cross_attention.cross_attn.attention.q_proj.weight"].numpy(),
        ca["attention"]["q_proj"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        sd["perceiver_ar.self_attention.layers.1.mlp.norm.weight"].numpy(),
        params["perceiver_ar"]["self_attention"]["layers_1"]["mlp"]["norm"]["scale"],
    )
    np.testing.assert_array_equal(
        t_model.perceiver_ar.input_adapter.txt_embedding.weight.detach().numpy(),
        params["perceiver_ar"]["input_adapter"]["txt_embedding"]["embedding"],
    )
    with pytest.raises(RuntimeError):  # strict load: a missing key fails
        t_model.load_state_dict({k: v for k, v in sd.items() if "o_proj" not in k}, strict=True)


@pytest.mark.parametrize("n,prefix_len,pads", [
    (12, 6, None), (12, 6, (0, 3)), (9, 3, (4, 1)), (5, 0, (0, 2)),
])
def test_clm_logits_match(pair, rng, n, prefix_len, pads):
    j_model, params, t_model = pair
    x = rng.integers(1, 64, (2, n)).astype(np.int32)
    pad_mask = None
    if pads is not None:
        pad_mask = np.arange(n)[None, :] < np.array(pads)[:, None]
    expected = j_model.apply({"params": params}, jnp.asarray(x), prefix_len=prefix_len,
                             pad_mask=None if pad_mask is None else jnp.asarray(pad_mask))
    with torch.no_grad():
        actual = t_model(torch.from_numpy(x), prefix_len,
                         None if pad_mask is None else torch.from_numpy(pad_mask))
    # all positions, padded ones included: on the CPU both packages run the
    # einsum path, so even rows that see only padding agree
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), **TOL)


def test_length_guards(pair):
    _, _, t_model = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        t_model(torch.ones((1, 13), dtype=torch.long), 6)
    with pytest.raises(ValueError, match="max_prefix_len"):
        t_model(torch.ones((1, 12), dtype=torch.long), 7)


def _window(rng, pads, n=12):
    window = rng.integers(1, 64, (len(pads), n)).astype(np.int32)
    return window, np.asarray(pads, np.int32)


@pytest.mark.parametrize("pads,m", [((0, 0), 6), ((2, 0), 3), ((5, 1), 4), ((0, 3), 1)])
def test_decode_forward_and_prefill_logits(pair, rng, pads, m):
    j_model, params, t_model = pair
    window, pad_count = _window(rng, pads)
    exp_fwd = j_model.apply({"params": params}, jnp.asarray(window), jnp.asarray(pad_count),
                            jnp.asarray(m), method=jax_gen._decode_forward)
    exp_pre, exp_cache, exp_len, _ = j_model.apply(
        {"params": params}, jnp.asarray(window), jnp.asarray(pad_count), jnp.asarray(m),
        method=jax_gen._decode_prefill,
    )
    tw, tp = torch.from_numpy(window), torch.from_numpy(pad_count).long()
    with torch.no_grad():
        fwd = gen._decode_forward(t_model, tw, tp, m)
        pre, cache, length, _ = gen._decode_prefill(t_model, tw, tp, m)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(exp_fwd), **TOL)
    np.testing.assert_allclose(pre.numpy(), np.asarray(exp_pre), **TOL)
    np.testing.assert_array_equal(length.numpy(), np.asarray(exp_len))
    # the caches' real rows: cross k/v below length, stack k/v below m
    for row, n_real in enumerate(np.asarray(exp_len)):
        np.testing.assert_allclose(cache["cross_k"][row, :, :n_real].numpy(),
                                   np.asarray(exp_cache["cross_k"])[row, :, :n_real], **TOL)
        np.testing.assert_allclose(cache["cross_v"][row, :, :n_real].numpy(),
                                   np.asarray(exp_cache["cross_v"])[row, :, :n_real], **TOL)
    for a, b in zip(cache["stack_k"], exp_cache["stack_k"]):
        np.testing.assert_allclose(a[:, :, :m].numpy(), np.asarray(b)[:, :, :m], **TOL)


@pytest.mark.parametrize("pads,m", [((4, 4), 3), ((6, 3), 2), ((3, 5), 4)])
def test_decode_step_logits(pair, rng, pads, m):
    # prefill, then two latent-growth steps on both packages (the window has
    # room to append: length < max_seq_len, m + 2 <= max_latents)
    j_model, params, t_model = pair
    window, pad_count = _window(rng, pads)
    args = (jnp.asarray(window), jnp.asarray(pad_count), jnp.asarray(m))
    _, j_cache, j_len, j_m = j_model.apply({"params": params}, *args, method=jax_gen._decode_prefill)
    with torch.no_grad():
        _, t_cache, t_len, t_m = gen._decode_prefill(
            t_model, torch.from_numpy(window), torch.from_numpy(pad_count).long(), m
        )
    for step in range(2):
        token = rng.integers(1, 64, (2,)).astype(np.int32)
        j_logits, j_cache, j_len, j_m = j_model.apply(
            {"params": params}, jnp.asarray(token), j_cache, j_len, j_m, method=jax_gen._decode_step
        )
        with torch.no_grad():
            t_logits, t_cache, t_len, t_m = gen._decode_step(
                t_model, torch.from_numpy(token), t_cache, t_len, t_m
            )
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
        assert t_m == int(j_m)


@pytest.mark.parametrize("pads", [(2, 2), (3, 6)])
def test_decode_step_boundary_logits(pair, rng, pads):
    # m == max_latents: prefill, then boundary steps with the window slid by
    # one token each (pad counts fit the nominal prefix and leave room for
    # two appends)
    j_model, params, t_model = pair
    window, pad_count = _window(rng, pads)
    args = (jnp.asarray(window), jnp.asarray(pad_count), jnp.asarray(6))
    _, j_cache, j_len, _ = j_model.apply({"params": params}, *args, method=jax_gen._decode_prefill)
    with torch.no_grad():
        _, t_cache, t_len, _ = gen._decode_prefill(
            t_model, torch.from_numpy(window), torch.from_numpy(pad_count).long(), 6
        )
    jk, jv = j_cache["cross_k"], j_cache["cross_v"]
    tk, tv = t_cache["cross_k"], t_cache["cross_v"]
    for step in range(2):
        token = rng.integers(1, 64, (len(pads),)).astype(np.int32)
        window = np.concatenate([window[:, 1:], token[:, None]], axis=1)
        pad_count = np.maximum(pad_count - 1, 0)
        j_logits, jk, jv, j_len = j_model.apply(
            {"params": params}, jnp.asarray(window), jnp.asarray(pad_count), jk, jv, j_len,
            method=jax_gen._decode_step_boundary,
        )
        with torch.no_grad():
            t_logits, tk, tv, t_len = gen._decode_step_boundary(
                t_model, torch.from_numpy(window), torch.from_numpy(pad_count).long(), tk, tv, t_len
            )
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
        np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))

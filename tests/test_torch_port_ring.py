"""The port's ring attention against the JAX package's, on the CPU: JAX's
``CASES`` (``tests/test_ring_attention.py``: square, right-aligned and
causal, padded) over ``seq=2`` and ``seq=4`` worlds of rank processes,
against JAX's unsharded einsum attention and its ``ring_attention_sharded``
(atol/rtol 1e-5), the gradients of q, k and v against the unsharded
attention's (1e-5), the refusals, the model-level ``attention_impl="ring"``
dispatch against ``xla`` (2e-5) and the warning without a ``seq`` mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests._torch_port_parallel import run_world
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.ops.attention import _attention_xla
from perceiver_io_tpu.parallel import ring_attention_sharded as jax_ring
from perceiver_io_tpu_torch.convert.from_jax import state_dict_from_jax
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops.attention import dot_product_attention

# JAX's CASES: (i, j, causal, with_pad), every one of them
CASES = [(64, 64, False, False), (64, 64, True, False), (64, 192, True, False), (64, 192, False, True),
         (64, 192, True, True)]
TOL = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(vocab_size=32, max_seq_len=32, max_latents=16, num_channels=16, num_heads=2,
             num_self_attention_layers=1, cross_attention_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs():
    rng = np.random.default_rng(0)
    out = []
    for i, j, causal, with_pad in CASES:
        q = (rng.standard_normal((2, 2, i, 16)) * 16 ** -0.5).astype(np.float32)
        k = rng.standard_normal((2, 2, j, 16)).astype(np.float32)
        v = rng.standard_normal((2, 2, j, 16)).astype(np.float32)
        pad = (rng.random((2, j)) < 0.2) if with_pad else None
        out.append((q, k, v, pad, causal))
    return out


def _model_pair():
    j_model = JaxCLM(JaxCLMConfig(**MODEL))
    params = jax.jit(j_model.init, static_argnums=2)(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32),
                                                    16)["params"]
    ids = np.random.default_rng(1).integers(1, 32, (2, 32))
    out = jax.jit(lambda p, x: j_model.apply({"params": p}, x, 16))(params, jnp.asarray(ids, jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params), ids, np.asarray(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, ids, xla_logits = _model_pair()
    build = ("perceiver_io_tpu_torch.models.text.clm", "CausalLanguageModel", CausalLanguageModelConfig(**MODEL),
             {"attention_impl": "ring"})
    model_case = dict(build=build, state_dict=state_dict_from_jax(params), ids=ids, prefix_len=16)
    out = {"xla_logits": xla_logits}
    for seq in (2, 4):
        cases = [("ring", "ring", dict(cases=_inputs(), seq=seq)),
                 ("refusals", "ring_refusals", dict(seq=seq)),
                 ("model", "ring_model", dict(model_case, seq=seq))]
        out[seq] = run_world(tmp_path_factory.mktemp("ring"), seq, cases)
    return out


def _reference(q, k, v, pad, causal):
    """JAX's unsharded attention and the gradients of ``sum(out ** 2)``
    (under ``jax.jit``: eager JAX is several times slower)."""
    pad = None if pad is None else jnp.asarray(pad)

    def attend(q, k, v):
        return _attention_xla(q, k, v, pad, causal, 0.0, None)

    out, vjp = jax.jit(lambda q, k, v: jax.vjp(attend, q, k, v))(q, k, v)
    grads = jax.jit(vjp)(2.0 * out)  # d sum(o ** 2) / do = 2 o
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("seq", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{i}x{j}-causal{c}-pad{p}" for i, j, c, p in CASES])
def test_ring_matches_jax(runs, case, seq):
    q, k, v, pad, causal = _inputs()[case]
    expected, grads = _reference(q, k, v, pad, causal)
    mesh = Mesh(np.asarray(jax.devices()[:seq]).reshape(seq), ("seq",))
    ring = jax.jit(lambda q, k, v, pad: jax_ring(q, k, v, mesh, pad_mask=pad, causal=causal))
    jax_out = np.asarray(ring(q, k, v, None if pad is None else jnp.asarray(pad)))
    for rank in runs[seq]:  # every rank of the group holds the whole output and gradients
        got = rank["ring"][case]
        np.testing.assert_allclose(got["o"], expected, **TOL)
        np.testing.assert_allclose(got["o"], jax_out, **TOL)
        for name, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[name], want, err_msg=name, **TOL)
        # the k/v chunks rotate seq - 1 times forward; k, v, dk, dv seq - 1
        # times and dk, dv once more backward
        sends = rank["ring"][case]["counts"]["send_recv"]["calls"]
        per_pad = 1 if pad is not None else 0
        assert sends == (seq - 1) * (2 + per_pad) + (seq - 1) * (4 + per_pad) + 2


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_rejects_indivisible_and_causal_short_keys(runs, seq):
    msgs = runs[seq][0]["refusals"]
    assert "must divide" in msgs[0] and "must divide" in msgs[1]
    assert "kv_len >= q_len" in msgs[2]


@pytest.mark.parametrize("seq", [2, 4])
def test_model_level_ring_dispatch(runs, seq):
    """``attention_impl="ring"`` under a ``seq`` mesh: the CLM's logits equal
    JAX's ``xla`` model's, every attend through the ring."""
    got = runs[seq][0]["model"]
    np.testing.assert_allclose(got["logits"], runs["xla_logits"], atol=2e-5, rtol=2e-5)
    assert got["counts"]["send_recv"]["calls"] > 0


def test_ring_without_seq_mesh_falls_back_with_warning():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 2, 16, 16)).astype(np.float32) for _ in range(3))
    with pytest.warns(UserWarning, match="seq"):
        out = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)), impl="ring", causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(_attention_xla(q, k, v, None, True, 0.0, None)),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="dropout"):
        dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)), impl="ring", dropout_rate=0.1)

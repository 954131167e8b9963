"""The port's attention and residual dropout against the JAX package, on the
CPU.

JAX's dropout draws (``jax.random.bernoulli``, recorded through an ordered
debug callback under ``jax.jit``) are replayed in the same order through the port's one draw site,
``ops.attention.dropout_keep`` (``tests/_torch_port_training.py``). Then:
the attend with and without ``max_heads_parallel`` (one draw per head
group), residual dropout, and a small Perceiver AR's train-mode logits and
gradients with prefix, attention and residual dropout equal JAX's (fp32,
outputs atol/rtol 1e-5, gradients atol 1e-5 / rtol 1e-4). ``impl="flash"``
with dropout raises as JAX's does, and the port's own masks keep ``1 - p``
of the entries and repeat under one seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_training import (
    GRAD_TOL, LATENTS, LOSS_RTOL, PREFIX, Recorder, Replay, assert_grads, batches, pair, to_torch,
)
from perceiver_io_tpu.models.core.modules import _ResidualDropout as JaxResidualDropout
from perceiver_io_tpu.ops.attention import dot_product_attention as jax_attention
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu_torch.models.core import modules
from perceiver_io_tpu_torch.ops import attention
from perceiver_io_tpu_torch.training import clm_loss_fn

RATES = dict(cross_attention_dropout=0.5, post_attention_dropout=0.2, residual_dropout=0.1)


def _qkv(rng, b=2, h=4, i=5, j=9, d=8):
    return [rng.standard_normal(s).astype(np.float32) for s in ((b, h, i, d), (b, h, j, d), (b, h, j, d))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("max_heads_parallel", [None, 3])
def test_attention_dropout_matches_jax(monkeypatch, rng, max_heads_parallel):
    q, k, v = _qkv(rng)
    pad = np.zeros((2, 9), bool)
    pad[1, :3] = True
    recorder = Recorder()
    monkeypatch.setattr(jax.random, "bernoulli", recorder)
    expected = jax.jit(lambda q, k, v, pad: jax_attention(
        q, k, v, pad_mask=pad, causal=True, dropout_rate=0.3, dropout_rng=jax.random.PRNGKey(4),
        max_heads_parallel=max_heads_parallel, impl="xla"))(q, k, v, pad)
    jax.effects_barrier()
    groups = 1 if max_heads_parallel is None else -(-4 // max_heads_parallel)
    assert len(recorder.masks) == groups
    replay = Replay(recorder.masks)
    monkeypatch.setattr(attention, "dropout_keep", replay)
    gen = torch.Generator().manual_seed(0)
    for impl in ("xla", "auto"):  # auto takes the plain path under dropout
        got = attention.dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pad_mask=torch.from_numpy(pad),
            causal=True, dropout_rate=0.3, generator=gen, max_heads_parallel=max_heads_parallel, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5, rtol=1e-5)
        assert replay.used == groups
        replay.by_state.clear()


def test_flash_with_dropout_raises_as_jax(rng):
    q, k, v = _qkv(rng)
    with pytest.raises(ValueError, match="dropout"):
        jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_rate=0.1,
                      dropout_rng=jax.random.PRNGKey(0), impl="flash")
    with pytest.raises(ValueError, match="dropout"):
        attention.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                        dropout_rate=0.1, impl="flash")


def test_residual_dropout_matches_flax(monkeypatch, rng):
    branch, x = (rng.standard_normal((3, 7, 16)).astype(np.float32) for _ in range(2))
    recorder = Recorder()
    monkeypatch.setattr(jax.random, "bernoulli", recorder)
    expected = jax.jit(lambda b, x: JaxResidualDropout(0.25).apply(
        {}, b, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(2)}))(branch, x)
    jax.effects_barrier()
    monkeypatch.setattr(attention, "dropout_keep", Replay(recorder.masks))
    layer = modules._ResidualDropout(0.25)
    gen = torch.Generator().manual_seed(1)
    got = layer(torch.from_numpy(branch), torch.from_numpy(x), deterministic=False, generator=gen)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-6, rtol=1e-6)
    same = layer(torch.from_numpy(branch), torch.from_numpy(x), deterministic=True, generator=gen)
    np.testing.assert_array_equal(same.numpy(), branch + x)


def _noise(monkeypatch, rng, b):
    """The same prefix-dropout scores for both packages (as
    ``tests/test_torch_port_train.py`` feeds them)."""
    noise = rng.random((b, PREFIX)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(noise))
    monkeypatch.setattr(modules, "prefix_noise", lambda b, n, g, device: torch.from_numpy(noise))


def test_train_mode_forward_and_grads_match_jax(monkeypatch, rng):
    """Prefix 0.5, attention 0.2 and residual 0.1 dropout with two head
    groups: logits, loss and gradients equal JAX's under the same masks.
    3 layers (cross + 2) x 3 sites and one more for the second head group
    (JAX passes ``max_heads_parallel`` to the cross-attention alone): 10
    draws, all used."""
    j_model, params, t_model = pair(max_heads_parallel=2, **RATES)
    batch = batches(1, batch_size=4, pads=[0, 2, 5, 7])[0]
    _noise(monkeypatch, rng, 4)
    recorder = Recorder()
    monkeypatch.setattr(jax.random, "bernoulli", recorder)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def run(params, batch):
        d, p = jax.random.split(key)  # tasks._rngs: the loss function's streams
        logits = j_model.apply({"params": params}, batch["input_ids"], PREFIX, pad_mask=batch["pad_mask"],
                               deterministic=False, rngs={"dropout": d, "prefix": p})
        loss_fn = jax_tasks.clm_loss_fn(j_model, LATENTS)
        return logits, jax.value_and_grad(loss_fn, has_aux=True)(params, batch, key)

    j_logits, ((j_loss, _), j_grads) = run(params, batch)
    jax.effects_barrier()
    draws = 10
    assert len(recorder.masks) == 2 * draws  # the logits' forward, then the loss's: the same keys
    for a, b in zip(recorder.masks[:draws], recorder.masks[draws:]):
        np.testing.assert_array_equal(a, b)

    replay = Replay(recorder.masks)
    monkeypatch.setattr(attention, "dropout_keep", replay)
    gen = torch.Generator().manual_seed(0)
    t = to_torch(batch)
    logits = t_model(t["input_ids"], PREFIX, pad_mask=t["pad_mask"], deterministic=False, generator=gen)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=1e-5, rtol=1e-5)
    assert replay.used == draws
    replay.by_state.clear()
    loss, _ = clm_loss_fn(t_model, LATENTS)(t_model, t, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    assert_grads(t_model, j_grads, **GRAD_TOL)


def test_eval_mode_draws_nothing(monkeypatch):
    """``deterministic=True`` with every rate set: no draw, the logits of the
    same model without dropout."""
    _, _, t_model = pair(**RATES)
    _, _, clean = pair()
    monkeypatch.setattr(attention, "dropout_keep", lambda *a: pytest.fail("a deterministic pass drew"))
    ids = to_torch(batches(1, batch_size=2)[0])["input_ids"]
    np.testing.assert_array_equal(t_model(ids, PREFIX).detach().numpy(), clean(ids, PREFIX).detach().numpy())


def test_port_masks_keep_one_minus_p_and_repeat():
    a = attention.dropout_keep((400, 500), 0.3, torch.Generator().manual_seed(5), torch.device("cpu"))
    b = attention.dropout_keep((400, 500), 0.3, torch.Generator().manual_seed(5), torch.device("cpu"))
    assert a.dtype == torch.bool and torch.equal(a, b)
    assert abs(a.float().mean().item() - 0.7) < 5e-3
    x = torch.ones(1000, 100)
    y = attention.dropout(x, 0.25, torch.Generator().manual_seed(6))
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1) / np.float32(0.75))}
    assert torch.equal(attention.dropout(x, 0.0, None), x) and not attention.dropout(x, 1.0, None).any()

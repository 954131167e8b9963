"""The port's token embedding (``ops/embedding.py``) on the CPU.

``Embedding`` is ``nn.Embedding`` with a backward whose additions run in a
fixed order (tokens sorted by id, each id's rows summed in token order in
fp32), so a training step's gradient is the same on every run; the CUDA
``nn.Embedding`` backward adds with atomics. Its forward and gradient are
held against ``nn.Embedding``'s and against JAX's (``jax.grad`` of a take
from the table), at 1e-6 in fp32, with repeated ids, ids no token reads
(a zero row) and bf16 output gradients; its repeated backward is held bit
for bit. The text input adapters build their tables from it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu_torch.models.sequence import SequenceInputAdapter
from perceiver_io_tpu_torch.models.text.common import TextInputAdapter
from perceiver_io_tpu_torch.ops.embedding import Embedding, embedding_grad


def _case(rng, vocab, shape, channels):
    ids = rng.integers(0, vocab - 3, shape)  # the last 3 rows read by no token
    ids.reshape(-1)[: ids.size // 2] = 5  # one id shared by half the tokens
    weight = rng.standard_normal((vocab, channels)).astype(np.float32)
    grad = rng.standard_normal((*shape, channels)).astype(np.float32)
    return ids, weight, grad


@pytest.mark.parametrize("id_type", [np.int64, np.int32])  # the collators' ids are int32
@pytest.mark.parametrize("vocab,shape,channels", [(262, (4, 300), 16), (40, (2, 3, 50), 8), (7, (1,), 4)])
def test_embedding_matches_nn_embedding_and_jax(rng, vocab, shape, channels, id_type):
    ids, weight, grad = _case(rng, vocab, shape, channels)
    ids = ids.astype(id_type)
    emb = Embedding(vocab, channels)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(weight))
    ref = torch.nn.Embedding(vocab, channels)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(weight))
    tids = torch.from_numpy(ids)
    out, want = emb(tids), ref(tids)
    assert torch.equal(out, want)
    out.backward(torch.from_numpy(grad))
    want.backward(torch.from_numpy(grad))
    np.testing.assert_allclose(emb.weight.grad.numpy(), ref.weight.grad.numpy(), atol=1e-6, rtol=1e-6)
    jax_grad = jax.grad(lambda w: jnp.sum(jnp.take(w, jnp.asarray(ids), axis=0) * jnp.asarray(grad)))(
        jnp.asarray(weight))
    np.testing.assert_allclose(emb.weight.grad.numpy(), np.asarray(jax_grad), atol=1e-6, rtol=1e-6)
    assert (emb.weight.grad[vocab - 3:] == 0).all()


def test_embedding_grad_is_the_same_every_run_and_keeps_the_type(rng):
    ids, _, grad = _case(rng, 262, (8, 512), 32)
    tids, tgrad = torch.from_numpy(ids), torch.from_numpy(grad)
    first = embedding_grad(tgrad, tids, 262)
    assert all(torch.equal(first, embedding_grad(tgrad, tids, 262)) for _ in range(3))
    # bf16 output gradients: summed in fp32, rounded to bf16 once at the end
    half = tgrad.to(torch.bfloat16)
    got = embedding_grad(half, tids, 262)
    assert got.dtype == torch.bfloat16 and got.shape == (262, 32)
    assert torch.equal(got, embedding_grad(half.float(), tids, 262).to(torch.bfloat16))


def test_embedding_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="padding_idx"):
        Embedding(10, 4, padding_idx=0)(torch.tensor([1, 2]))


def test_text_input_adapters_use_it():
    assert isinstance(TextInputAdapter(262, 16, 8).txt_embedding, Embedding)
    assert isinstance(TextInputAdapter(262, 16, 8).pos_embedding, Embedding)
    seq = SequenceInputAdapter(262, 16, 8, 4)
    assert isinstance(seq.txt_embedding, Embedding) and isinstance(seq.pos_embedding, Embedding)

"""K4's routes behind ``ragged_paged_attention``, on the CPU.

The wrapper picks the kernel's design from the query length alone
(``_k4_route``): ``split`` for decode rows (at most 16 queries a row,
``csrc/ragged_paged_attention_split.cu``) and ``tc`` for window rows
(``csrc/ragged_paged_attention_tc.cu``); ``simt`` (the first design) is
reached only by name. The kernels run only on the card, so their arithmetic
is emulated here in plain torch, in each kernel's own order:

- ``split``: each row's keys cut into 64-key splits; per split and query
  the partial max (the ``-1e30`` sentinel where the query sees none of the
  split's keys), ``l = sum p`` and ``acc = p . v`` in fp32 over the
  dequantized pages (``int8 * scale``), then the merge
  ``m = max m_s``, ``o = sum acc_s e^(m_s - m) / max(sum l_s e^(m_s - m), 1e-30)``
  over the splits with ``l_s > 0``;
- ``tc``: two online-softmax states per query (the two warps of a 16-query
  group, each over 32 of every 64-key tile), each rescaled by
  ``exp(m_old - m_new)`` per tile and merged at the end; the products as the
  kernel takes them on the tensor cores (``tests/_torch_port_tf32.py``):
  3xTF32 over fp32 pools (``mm3``), ``a_lo.b + a_hi.b`` over bf16 and int8
  values, which are exact in TF32 (``mm2``), and one exact product for a
  bf16 q over such a pool; int8 scales applied per key to the scores and to
  ``p`` before ``p . v``; ``p`` never rounded to bf16.

Each emulation is held against the JAX package's K4,
``ragged_paged_attention`` run as JAX's own tests run it on the CPU (the
Pallas kernel in interpret mode), on rows with a span that ends mid-page,
tail pages on the null block, trash in the null block (garbage bytes
under zero scales for int8), an idle row and a row shorter than the query
(its first queries dead, exactly 0). fp32 outputs at 1e-5 abs: both sides
are fp32-accurate (3xTF32 drops ~2^-21 relative per product); measured on
the CPU, the largest difference is 3.6e-7, where one TF32 product per fp32
product lands at 1.2e-3. bf16 outputs at one bf16 ulp of each entry (rtol
2^-7): both sides compute the same value to fp32 accuracy and round it to
bf16 once, so an entry can land on the neighbouring bf16 value and no
further (measured: at most 3 entries of a case do). Each 3xTF32 term is exact here and
the exponentials are torch's; the card's own rounding is held by
``chip_smoke.py``'s ``k4`` phase.

The wrapper's refusals (a type, a query length or a base a route does not
take) raise before the route's library loads, so they are pinned here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import paged_attention as jax_paged
from perceiver_io_tpu.ops import ragged_attention as jax_ragged
from perceiver_io_tpu_torch.ops import ragged_attention as ragged
from tests._torch_port_tf32 import mm2, mm3

SPLIT, TILE, HALF = 64, 64, 32
NEG = ragged.NEG
H, D, BS, PAGES = 2, 32, 16, 10
# a span ending mid-page, a span shorter than 100 queries (tail pages
# unmapped), an idle row, the whole table
LENGTHS = [150, 37, 0, 160]
# (name, q dtype, pool dtype)
LAYOUTS = {"float32": (torch.float32, torch.float32), "bfloat16": (torch.bfloat16, torch.bfloat16),
           "int8": (torch.float32, torch.int8), "int8_bf16_q": (torch.bfloat16, torch.int8)}


def _inputs(rng, layout: str, q_len: int, d: int = D, lengths=LENGTHS):
    """``(q, pool_k, pool_v, table, lengths, scale_k, scale_v)`` as torch
    tensors: pages of the live spans on shuffled blocks, the null block
    full of trash."""
    q_dtype, pool_dtype = LAYOUTS[layout]
    b = len(lengths)
    used = [-(-n // BS) for n in lengths]
    blocks = rng.permutation(sum(used)) + 1
    table = np.zeros((b, PAGES), np.int32)
    start = 0
    for r, u in enumerate(used):
        table[r, :u] = blocks[start:start + u]
        start += u
    tokens = (sum(used) + 1) * BS
    pool_k = rng.standard_normal((tokens, H, d)).astype(np.float32)
    pool_v = rng.standard_normal((tokens, H, d)).astype(np.float32)
    pool_k[:BS], pool_v[:BS] = 1e3, -1e3
    q = rng.standard_normal((b, H, q_len, d)).astype(np.float32) * d**-0.5
    sk = sv = None
    if pool_dtype == torch.int8:
        pool_k, sk = (np.asarray(a).copy() for a in jax_paged.quantize_kv(jnp.asarray(pool_k)))
        pool_v, sv = (np.asarray(a).copy() for a in jax_paged.quantize_kv(jnp.asarray(pool_v)))
        pool_k[:BS], pool_v[:BS], sk[:BS], sv[:BS] = 119, -77, 0.0, 0.0
        sk, sv = torch.from_numpy(sk), torch.from_numpy(sv)
    t = lambda a, dtype: torch.from_numpy(a).to(dtype)  # noqa: E731
    return (t(q, q_dtype), t(pool_k, pool_dtype), t(pool_v, pool_dtype), torch.from_numpy(table),
            torch.tensor(lengths, dtype=torch.int32), sk, sv)


def _jax(q, pool_k, pool_v, table, lengths, sk, sv) -> torch.Tensor:
    j = lambda t: jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())  # noqa: E731
    scales = {} if sk is None else dict(scale_k=j(sk), scale_v=j(sv))
    qj = j(q).astype(jnp.bfloat16) if q.dtype == torch.bfloat16 else j(q)
    pool_type = jnp.bfloat16 if pool_k.dtype == torch.bfloat16 else None
    pk, pv = j(pool_k), j(pool_v)
    if pool_type is not None:
        pk, pv = pk.astype(pool_type), pv.astype(pool_type)
    out = jax_ragged.ragged_paged_attention(qj, pk, pv, j(table), j(lengths), block_size=BS, **scales)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _pages(pool, table, scale):
    """Every position of the table's span as ``(b, h, n, d)`` fp32 (int8
    values raw) and its scales ``(b, h, 1, n)`` (or None)."""
    n = table.shape[1] * BS
    pos = torch.arange(n)
    flat = table.long()[:, pos // BS] * BS + pos % BS
    vals = pool[flat].float().permute(0, 2, 1, 3)
    return vals, (None if scale is None else scale[flat][..., 0].permute(0, 2, 1)[:, :, None, :])


def _visible(lengths, q_len: int, n: int) -> torch.Tensor:
    """``(b, 1, q_len, n)``: query ``qi`` sees positions below ``lengths - q_len + 1 + qi``."""
    pos = torch.arange(n)
    qi = torch.arange(q_len)[:, None]
    return ((pos[None] + (q_len - 1) - qi)[None] < lengths.long()[:, None, None])[:, None]


def split_forward(q, pool_k, pool_v, table, lengths, sk=None, sv=None) -> torch.Tensor:
    """K4's output as the ``split`` route computes it."""
    k, skd = _pages(pool_k, table, sk)
    v, svd = _pages(pool_v, table, sv)
    if skd is not None:  # dequantized on the way into shared memory
        k = k * skd[:, :, 0, :, None]
        v = v * svd[:, :, 0, :, None]
    n = k.shape[2]
    vis = _visible(lengths, q.shape[2], n)
    span = lengths.long().clamp(0, n)
    ms, ls, accs = [], [], []
    for c0 in range(0, n, SPLIT):
        cols = slice(c0, c0 + SPLIT)
        ok = vis[..., cols]
        s = torch.where(ok, q.float() @ k[:, :, cols].transpose(-1, -2), NEG)
        m = s.amax(-1, keepdim=True)
        p = torch.where(ok, torch.exp(s - m), 0.0)
        live = (c0 < span)[:, None, None, None]  # a split past the span writes l = 0
        ms.append(m)
        ls.append(torch.where(live, p.sum(-1, keepdim=True), 0.0))
        accs.append(p @ v[:, :, cols])
    m_s, l_s, acc_s = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    has = l_s > 0
    m = torch.where(has, m_s, NEG).amax(0)
    w = torch.where(has, torch.exp(m_s - m), 0.0)
    l = (l_s * w).sum(0)
    acc = torch.where(has, acc_s * w, 0.0).sum(0)
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


def tc_forward(q, pool_k, pool_v, table, lengths, sk=None, sv=None) -> torch.Tensor:
    """K4's output as the ``tc`` route computes it."""
    k, skd = _pages(pool_k, table, sk)
    v, svd = _pages(pool_v, table, sv)
    n = k.shape[2]
    vis = _visible(lengths, q.shape[2], n)
    qf = q.float()
    states = []
    for c_half in (0, HALF):  # the two warps of a 16-query group
        m = torch.full(q.shape[:3] + (1,), NEG)
        l, acc = torch.zeros(q.shape[:3] + (1,)), torch.zeros(q.shape[:3] + (v.shape[-1],))
        for c0 in range(c_half, n, TILE):
            cols = slice(c0, c0 + HALF)
            ok = vis[..., cols]
            kt = k[:, :, cols].transpose(-1, -2)
            if pool_k.dtype == torch.float32:
                s = mm3(qf, kt)
            elif q.dtype == torch.bfloat16:  # both operands exact in TF32: one product
                s = (qf.double() @ kt.double()).float()
            else:
                s = mm2(qf, kt)
            if skd is not None:
                s = s * skd[..., cols]
            s = torch.where(ok, s, NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.where(m == m_new, 1.0, torch.exp(m - m_new))
            p = torch.where(ok, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            if svd is not None:
                p = p * svd[..., cols]
            acc = acc * alpha + (mm3 if pool_v.dtype == torch.float32 else mm2)(p, v[:, :, cols])
            m = m_new
        states.append((m, l, acc))
    (ma, la, acca), (mb, lb, accb) = states
    mx = torch.maximum(ma, mb)
    wa, wb = torch.exp(ma - mx), torch.exp(mb - mx)
    return ((acca * wa + accb * wb) / (la * wa + lb * wb).clamp(min=1e-30)).to(q.dtype)


def _dead(lengths, q_len: int, d: int) -> torch.Tensor:
    """``(b, h, q_len, d)``: True where the query sees no key."""
    return ~_visible(lengths, q_len, PAGES * BS).any(-1, keepdim=True).expand(len(lengths), H, q_len, d)


def _assert_close(got, want, layout: str):
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=1e-6, rtol=2**-7)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("route,q_len", [("split", 1), ("split", 7), ("tc", 7), ("tc", 100)])
def test_route_emulation_matches_jax(rng, route, q_len, layout):
    q, pool_k, pool_v, table, lengths, sk, sv = _inputs(rng, layout, q_len)
    forward = split_forward if route == "split" else tc_forward
    got = forward(q, pool_k, pool_v, table, lengths, sk, sv)
    want = _jax(q, pool_k, pool_v, table, lengths, sk, sv)
    assert got.shape == q.shape and got.dtype == q.dtype and torch.isfinite(got).all()
    _assert_close(got, want, layout)
    dead = _dead(lengths, q_len, D)
    assert dead[2].all() and (got[dead] == 0).all()  # the idle row, and row 1's first queries at 100
    assert dead.sum() == H * q_len * D + (H * 63 * D if q_len == 100 else 0)


# the kernels' head dims, against the plain version, on a span of several
# splits and tiles
@pytest.mark.parametrize("d,q_len", [(64, 1), (112, 100), (128, 33)])
@pytest.mark.parametrize("layout", ["float32", "int8"])
def test_route_emulations_match_plain(rng, d, q_len, layout):
    inputs = _inputs(rng, layout, q_len, d=d)
    q, pool_k, pool_v, table, lengths, sk, sv = inputs
    want = ragged.ragged_paged_attention_reference(q, pool_k, pool_v, table, lengths, block_size=BS,
                                                   scale_k=sk, scale_v=sv)
    for forward in ((split_forward, tc_forward) if q_len <= ragged.SPLIT_MAX_ROWS else (tc_forward,)):
        got = forward(*inputs)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
        assert (got[_dead(lengths, q_len, d)] == 0).all()


def test_k4_route_table():
    for q_len, dtype, route in ((1, torch.float32, "split"), (16, torch.bfloat16, "split"),
                                (17, torch.float32, "tc"), (100, torch.bfloat16, "tc"),
                                (512, torch.float32, "tc")):
        assert ragged._k4_route(q_len, dtype) == route
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ragged._k4_route(1, torch.float16)
    assert ragged.ROUTES == ("split", "tc", "simt")
    assert ragged.ROUTE_KERNELS == {"split": 2, "tc": 1, "simt": 1}


def test_cpu_tensors_launch_no_route(rng):
    inputs = _inputs(rng, "int8", 1)
    q, pool_k, pool_v, table, lengths, sk, sv = inputs
    wrapper = ragged.ragged_paged_attention
    before = (wrapper.launches, dict(wrapper.route_launches), wrapper.kernel_launches)
    out = wrapper(q, pool_k, pool_v, table, lengths, block_size=BS, scale_k=sk, scale_v=sv)
    assert (wrapper.launches, dict(wrapper.route_launches), wrapper.kernel_launches) == before
    np.testing.assert_array_equal(out.numpy(), ragged.ragged_paged_attention_reference(
        q, pool_k, pool_v, table, lengths, block_size=BS, scale_k=sk, scale_v=sv).numpy())


@pytest.fixture
def no_library(monkeypatch):
    """Loading a route's library fails the test: a refusal must come first."""
    def load(route):
        raise AssertionError(f"the {route} library was loaded before the refusal")

    monkeypatch.setattr(ragged, "_kernel", load)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied onto a base one element (1, 2 or 4 bytes) off the allocation's."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view_as(t)
    out.copy_(t)
    return out


@pytest.mark.parametrize("route,layout,q_len", [
    ("split", "float32", 1), ("split", "int8_bf16_q", 16), ("tc", "bfloat16", 100), ("tc", "int8", 17),
])
def test_route_refuses_before_loading(rng, no_library, route, layout, q_len):
    q, pool_k, pool_v, table, lengths, sk, sv = _inputs(rng, layout, q_len)
    launch = lambda *a: ragged._k4_launch(route, *a, table, lengths, BS, sk, sv)  # noqa: E731
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(q.half(), pool_k, pool_v)
    with pytest.raises(TypeError, match="int8" if sk is not None else "q's type"):
        launch(q, pool_k.double(), pool_v.double())
    with pytest.raises(ValueError, match="16-byte"):
        launch(_misaligned(q), pool_k, pool_v)
    with pytest.raises(ValueError, match="16-byte"):
        launch(q, pool_k, _misaligned(pool_v))
    if route == "split":
        tall = torch.zeros(q.shape[0], H, ragged.SPLIT_MAX_ROWS + 1, D, dtype=q.dtype)
        with pytest.raises(ValueError, match="queries a row"):
            launch(tall, pool_k, pool_v)
    with pytest.raises(AssertionError, match="loaded"):  # aligned and of its types: it would load
        launch(q, pool_k, pool_v)

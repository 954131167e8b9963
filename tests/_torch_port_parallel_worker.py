"""One rank of the port's multi-process tests (``test_torch_port_parallel.py``,
``test_torch_port_parallel_train.py``, ``test_torch_port_ring.py``,
``test_torch_port_sharding.py``).

Argv: ``rank world job_dir``. The rank pins torch to one intra-op thread,
brings up a gloo world over a ``file://`` store under ``job_dir`` (no
port), runs every case of ``job_dir/job.pkl`` in order and writes its
results to ``job_dir/rank<r>.pkl``. It imports torch and the port only.
A case that raises fails the rank (non-zero exit), and with it the test.
"""
import importlib
import os
import pickle
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(build, state_dict=None):
    import torch

    module, cls, config, kwargs = build
    model = getattr(importlib.import_module(module), cls)(config, device="cpu", **kwargs)
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    return model


def _loss(model, loss):
    from perceiver_io_tpu_torch.training import tasks

    name, args = loss
    return getattr(tasks, name)(model, *args)


def _mesh(sizes):
    from perceiver_io_tpu_torch.parallel import MeshConfig, make_mesh

    return None if sizes is None else make_mesh(MeshConfig(**sizes), device="cpu")


def _patch_prefix_noise(noise):
    """Every prefix-dropout draw returns ``noise`` (the global table), as
    JAX's patched ``jax.random.uniform`` does; the generator advances."""
    import torch

    from perceiver_io_tpu_torch.models.core import modules

    def draw(b, n, generator, device):
        torch.rand(1, generator=generator, device=device)
        assert (b, n) == noise.shape, ((b, n), noise.shape)
        return torch.from_numpy(noise).to(device)

    modules.prefix_noise = draw


def trajectory(build, state_dict, loss, batches, mesh=None, lr=1e-2, clip=1.0, accum=1, multi=1,
               shard_seq=False, min_fsdp=0, generators=False, layout=()):
    """Losses of ``len(batches)`` Adam steps on ``mesh`` (None: no mesh, the
    whole batch on this rank), the collective counts of each step and, for
    the parameters named in ``layout``, the local shapes of the parameter
    and of its Adam moments after the last step."""
    import numpy as np
    import torch

    from perceiver_io_tpu_torch.parallel import (TrainState, collectives, create_train_state, make_train_step,
                                                 shard_batch)
    from perceiver_io_tpu_torch.training import make_optimizer
    from perceiver_io_tpu_torch.training.trainer import step_generator

    model = _model(build, state_dict)
    tx = make_optimizer(lr, optimizer="adam")
    m = _mesh(mesh)
    if m is None:
        state = TrainState.create(model, tx)
    else:
        state, _ = create_train_state(model, tx, m, min_fsdp_size=min_fsdp)
    step = make_train_step(_loss(model, loss), grad_clip_norm=clip, grad_accum_steps=accum,
                           multi_steps=multi, mesh=m, shard_seq=shard_seq, device="cpu")
    cpu = torch.device("cpu")
    losses, counts = [], []
    groups = [batches[i:i + multi] for i in range(0, len(batches), multi)]
    for i, group in enumerate(groups):
        gens = [step_generator(0, i * multi + j, cpu) for j in range(multi)] if generators else None
        collectives.reset_counts()
        if multi == 1:
            batch = group[0] if m is None else shard_batch(group[0], m, shard_seq=shard_seq)
            state, metrics = step(state, batch, gens[0] if gens else None)
            losses.append(float(metrics["loss"]))
        else:
            stacked = {k: np.stack([b[k] for b in group]) for k in group[0]}
            if m is not None:
                stacked = shard_batch(stacked, m, shard_seq=shard_seq, stacked_steps=True)
            state, metrics = step(state, stacked, gens)
            losses += [float(x) for x in metrics["loss"]]
        counts.append(collectives.read_counts())
    params = dict(state.model.named_parameters())
    shapes = {}
    for name in layout:
        moment = state.optimizer.state[params[name]]
        shapes[name] = dict(param=tuple(params[name].shape), full=state.placement.full_shapes[name],
                            exp_avg=tuple(moment["exp_avg"].shape),
                            exp_avg_sq=tuple(moment["exp_avg_sq"].shape),
                            spec=tuple(state.placement.specs[name]))
    final = state.model_state_dict() if m is not None else {k: v.detach() for k, v in model.state_dict().items()}
    return dict(losses=losses, counts=counts, layout=shapes,
                params={k: v.numpy() for k, v in final.items()})


def ring(cases, seq):
    """``ring_attention_sharded`` over a ``seq`` mesh: each case's output
    and the gradients of ``sum(out ** 2)`` for q, k and v."""
    import torch

    from perceiver_io_tpu_torch.parallel import collectives, ring_attention_sharded

    mesh = _mesh(dict(data=1, seq=seq))
    out = []
    for q, k, v, pad, causal in cases:
        q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        collectives.reset_counts()
        o = ring_attention_sharded(q, k, v, mesh, pad_mask=None if pad is None else torch.from_numpy(pad),
                                   causal=causal)
        (o ** 2).sum().backward()
        out.append(dict(o=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy(),
                        counts=collectives.read_counts()))
    return out


def ring_refusals(seq):
    """The messages of ``ring_attention_sharded``'s refusals."""
    import torch

    from perceiver_io_tpu_torch.parallel import ring_attention_sharded

    mesh = _mesh(dict(data=1, seq=seq))
    msgs = []
    for i, j, causal in ((63, 64, False), (64, 63, False), (64, 32, True)):
        q, k = torch.zeros(1, 1, i, 16), torch.zeros(1, 1, j, 16)
        try:
            ring_attention_sharded(q, k, k, mesh, causal=causal)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def ring_model(build, state_dict, ids, prefix_len, seq):
    """A CLM's logits with ``attention_impl="ring"`` under a ``seq`` mesh."""
    import torch

    from perceiver_io_tpu_torch.parallel import collectives

    model = _model(build, state_dict)
    mesh = _mesh(dict(data=1, seq=seq))
    collectives.reset_counts()
    with torch.no_grad(), mesh:
        logits = model(torch.from_numpy(ids), prefix_len)
    return dict(logits=logits.numpy(), counts=collectives.read_counts())


def trainer_fit(build, state_dict, loss, batches, mesh, root, trainer, noise=None, val=None,
                resume=None, lr=1e-2, per_rank_root=False):
    """``Trainer.fit`` over ``mesh`` with this rank's rows of each batch (its
    loader shard: rank ``r`` of ``n`` holds rows ``[r·b/n, (r+1)·b/n)``);
    returns rank 0's ``metrics.jsonl`` rows, the names under ``root`` (a
    root per rank with ``per_rank_root``; None where nothing was written)
    and the final parameters."""
    import json

    import torch.distributed as dist

    from perceiver_io_tpu_torch.training import Trainer, TrainerConfig, make_optimizer

    if noise is not None:
        _patch_prefix_noise(noise)
    m = _mesh(mesh)
    rank, world = dist.get_rank(), dist.get_world_size()
    if per_rank_root:
        root = os.path.join(root, f"rank{rank}")

    def shard(b):
        n = len(next(iter(b.values())))
        return {k: v[rank * n // world:(rank + 1) * n // world] for k, v in b.items()}

    model = _model(build, state_dict)
    cfg = TrainerConfig(**trainer, default_root_dir=root, resume=resume)
    t = Trainer(cfg, _loss(model, loss), make_optimizer(lr, optimizer="adam"), model_config=build[2],
                device="cpu", mesh=m)
    val_data = None if val is None else (lambda: iter([shard(b) for b in val]))
    state = t.fit(model, [shard(b) for b in batches], val_data=val_data)
    rows = None
    if rank == 0:
        rows = [json.loads(line) for line in open(os.path.join(root, "metrics.jsonl"))]
    return dict(rows=rows, step=state.step, wrote=sorted(os.listdir(root)) if os.path.isdir(root) else None,
                params={k: v.numpy() for k, v in state.model_state_dict().items()})


def multihost(build, state_dict, loss, dataset, batch_size):
    """``initialize`` (again: idempotent), ``host_shard_info``, the
    ``DataLoader``'s rank sharding and ``shard_or_assemble`` into one
    ``data``-mesh step; the loss and the ranks' rows."""
    import torch.distributed as dist

    from perceiver_io_tpu_torch.data.loader import DataLoader, host_shard_info
    from perceiver_io_tpu_torch.parallel import (create_train_state, initialize, is_multihost, make_mesh,
                                                 make_train_step, shard_or_assemble)
    from perceiver_io_tpu_torch.training import make_optimizer

    initialize(device="cpu")
    assert is_multihost() and host_shard_info() == (dist.get_rank(), dist.get_world_size())
    loader = DataLoader(dataset, batch_size=batch_size, prefetch=0)
    local = next(iter(loader))
    mesh = make_mesh(device="cpu")
    model = _model(build, state_dict)
    state, _ = create_train_state(model, make_optimizer(1e-2, optimizer="adam"), mesh)
    step = make_train_step(_loss(model, loss), mesh=mesh)
    placed = shard_or_assemble(local, mesh)
    _, metrics = step(state, placed, None)
    return dict(loss=float(metrics["loss"]), rows=local["input_ids"].tolist(),
                placed=placed["input_ids"].tolist())


def outside_mesh():
    """A mesh over the world's first rank: the other rank takes part in
    building it and raises when it uses it."""
    from perceiver_io_tpu_torch.parallel import MeshConfig, make_mesh, shard_batch

    mesh = make_mesh(MeshConfig(data=1), device="cpu")
    try:
        shard_batch({"x": __import__("numpy").zeros((2, 2))}, mesh)
        return dict(ranks=mesh.ranks, error=None)
    except RuntimeError as e:
        return dict(ranks=mesh.ranks, error=str(e))


def serving(**kwargs):
    """The sharded slot engine's scenarios (``tests/_torch_port_sharding_cases.py``)."""
    from tests import _torch_port_sharding_cases

    return _torch_port_sharding_cases.serving(**kwargs)


CASES = {f.__name__: f for f in (trajectory, ring, ring_refusals, ring_model, trainer_fit, multihost,
                                  outside_mesh, serving)}


def main() -> None:
    rank, world, job_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    import torch

    torch.set_num_threads(1)
    from perceiver_io_tpu_torch.parallel import multihost as mh

    mh.initialize(f"file://{os.path.join(job_dir, 'store')}", world, rank, device="cpu")
    print(f"start: {time.perf_counter() - t0:.2f} s", flush=True)
    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = {}
    try:
        for name, fn, kwargs in cases:
            t0 = time.perf_counter()
            results[name] = CASES[fn](**kwargs)
            print(f"case {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # the peers' collectives would wait: leave at once
    with open(os.path.join(job_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    mh.shutdown()


if __name__ == "__main__":
    main()

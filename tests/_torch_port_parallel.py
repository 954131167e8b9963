"""Shared pieces of the port's multi-process tests: :func:`run_world` starts
one gloo world of ``world`` rank processes (``tests/_torch_port_parallel_worker.py``)
over a ``file://`` store under a temporary directory (no port, so the
suite's parallel workers never collide), runs a list of cases in every rank
and returns each rank's results; the tiny models both packages build; and
the JAX single-device trajectory the sharded runs are held to.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_port_parallel_worker.py")
#: JAX's bar for a sharded trajectory against the single-device one
TRAJ_RTOL = 2e-4

VOCAB, SEQ, LATENTS, CH, HEADS = 32, 16, 8, 32, 4
PREFIX = SEQ - LATENTS
CLM_KW = dict(vocab_size=VOCAB, max_seq_len=SEQ, max_latents=LATENTS, num_channels=CH, num_heads=HEADS,
              num_self_attention_layers=2, cross_attention_dropout=0.0)


def run_world(tmp_dir, world: int, cases, timeout: float = 300.0) -> list:
    """Run ``cases`` (``[(name, worker function, kwargs)]``) in a world of
    ``world`` ranks; ``[results of rank r]``. A rank that fails or a world
    that outlives ``timeout`` kills every rank and raises."""
    job_dir = os.path.join(str(tmp_dir), f"world{world}")
    os.makedirs(job_dir, exist_ok=True)
    with open(os.path.join(job_dir, "job.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [open(os.path.join(job_dir, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), job_dir], env=env, cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:  # until every rank ends, one fails (its peers would wait in a collective) or time runs out
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r}:\n" + open(os.path.join(job_dir, f"rank{r}.log")).read()[-3000:]
                          for r in failed)
        raise RuntimeError(f"ranks {failed} of a world of {world} failed:\n{tails}")
    out = []
    for r in range(world):
        with open(os.path.join(job_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def clm_batches(n: int = 4, seed: int = 0):
    """CLM batches of 8 rows with uneven masks across two ranks: rows 0-1
    (rank 0 of a ``data=2`` mesh) padded on the left, rows 5-7 (rank 1)
    with their last four labels masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, size=(8, SEQ + 1)).astype(np.int64)
        labels = ids[:, 1:].copy()
        labels[5:, -4:] = -100
        pads = np.array([3, 5, 0, 0, 0, 0, 0, 0])
        out.append({"input_ids": ids[:, :-1], "labels": labels,
                    "pad_mask": np.arange(SEQ)[None, :] < pads[:, None]})
    return out


def jax_trajectory(j_model, params, loss_fn, batches, accum: int = 1):
    """JAX's single-device losses (a one-device mesh, Adam 1e-2, clip 1.0):
    the baseline every sharded trajectory is held to."""
    import jax
    import optax

    from perceiver_io_tpu.parallel import MeshConfig, create_train_state, make_mesh, make_train_step, shard_batch

    mesh = make_mesh(MeshConfig(data=1))
    state, shardings = create_train_state(lambda: params, optax.adam(1e-2), mesh, initial_params=params)
    step = make_train_step(loss_fn, mesh, shardings, grad_clip_norm=1.0, grad_accum_steps=accum)
    losses = []
    with mesh:
        for i, batch in enumerate(batches):
            state, m = step(state, shard_batch({k: np.asarray(v) for k, v in batch.items()}, mesh),
                            jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
    return losses

"""The rank side of ``tests/test_torch_port_sharding.py``: scenarios of the
sharded slot engine, run in every rank of a gloo world by
``tests/_torch_port_parallel_worker.py`` (case ``serving``).

Each scenario has a *setup* every rank runs at the same point (it resolves
the meshes or builds the allocator: process groups are created
collectively) and a *drive* the driver (rank 0) runs while the other ranks
follow the setup's target; the driver stops them at the end. A scenario
returns plain values (tokens as lists, stats, gauges) for the test to hold
against JAX's engines and the port's unsharded one.
"""

import numpy as np


def _cfg(max_new=6, num_latents=2, **sampling):
    from perceiver_io_tpu_torch.inference.generate import GenerationConfig
    from perceiver_io_tpu_torch.inference.samplers import SamplingConfig

    return GenerationConfig(max_new_tokens=max_new, num_latents=num_latents,
                            sampling=SamplingConfig(**(sampling or {"temperature": 0.0})))


def _table():
    from perceiver_io_tpu_torch.serving import BucketTable

    return BucketTable(prompt_lens=(8, 16), batch_sizes=(1,))


def _engine(model, mesh, cfg, slots=2, **kwargs):
    from perceiver_io_tpu_torch.serving import SlotServingEngine

    return SlotServingEngine(model, cfg, _table(), slots=slots, mesh=mesh, device="cpu", **kwargs)


def _tokens(outs):
    return [np.asarray(o).tolist() for o in outs]


def _digests_equal(engine) -> bool:
    """Every data replica of each model index holds the same pool bytes."""
    by_model = {}
    for _, model_index, digest in engine.shard_digests():
        by_model.setdefault(model_index, set()).add(digest)
    return all(len(d) == 1 for d in by_model.values())


def _identity(sharding) -> list:
    """The sharding's fingerprint as plain lists."""
    return [list(x) if isinstance(x, tuple) else x for x in sharding.fingerprint()]


def _spec(data, model, offset=0):
    from perceiver_io_tpu_torch.serving import ServingMeshSpec

    return ServingMeshSpec(data=data, model=model, device_offset=offset)


# -- scenarios: (setup on every rank) -> target; drive(model, target, **kw) ---
def setup_2x2():
    return _spec(2, 2).resolve(device="cpu")


def drive_parity(model, sh, geometries, prompts, max_new):
    """Greedy tokens of each geometry on the mesh, with its stats, gauges
    and pool checks."""
    out = {}
    for name, kwargs in geometries:
        eng = _engine(model, sh, _cfg(max_new=max_new), **kwargs)
        outs = eng.serve([np.asarray(p, np.int32) for p in prompts])
        stats, reg = eng.stats(), eng.registry
        rec = dict(tokens=_tokens(outs), completed=stats["completed"], mesh=stats["mesh"],
                   health_mesh=eng.health()["mesh"], describe=sh.describe(),
                   gauges={g: reg.gauge(g) for g in ("serving_mesh_devices", "serving_mesh_data",
                                                     "serving_mesh_model", "kv_cache_resident_bytes",
                                                     "kv_cache_resident_bytes_per_shard",
                                                     "kv_prefix_cached_blocks")},
                   hits=reg.counter("kv_prefix_hits_total"), plans=sh.plans)
        if eng._pool is not None:
            rec.update(in_use=eng._pool.in_use, leaked=eng._pool.leaked(),
                       replicas_equal=_digests_equal(eng))
        out[name] = rec
    return out


def drive_unsharded_twins(model, sh, prompts):
    """Sampled decoding, swap preemption and ``k2d1`` speculation on the
    mesh against the port's unsharded engine on the same model (rank 0's
    whole copy), and the pool replicas after each."""
    import torch

    from perceiver_io_tpu_torch.serving import SlotServingEngine

    prompts = [np.asarray(p, np.int32) for p in prompts]
    runs = {
        "sampled": (_cfg(max_new=6, do_sample=True, temperature=0.8, top_k=20),
                    dict(kv_layout="paged", kv_block_size=4)),
        "swap": (_cfg(max_new=10), dict(kv_layout="paged", kv_block_size=4, kv_blocks=8,
                                         preemption="swap")),
        "spec_k2d1": (_cfg(max_new=8), dict(kv_layout="paged", kv_block_size=4, speculation="k2d1")),
        "int8_chunked": (_cfg(max_new=6), dict(kv_layout="paged_int8", kv_block_size=4, prefill_chunk=8)),
    }
    out = {}
    for name, (cfg, kwargs) in runs.items():
        res = {}
        for label, mesh in (("plain", None), ("mesh", sh)):
            eng = SlotServingEngine(model, cfg, _table(), slots=4 if name != "swap" else 2, mesh=mesh,
                                    device="cpu", **kwargs)
            outs = eng.serve(prompts, generator=torch.Generator().manual_seed(7))
            stats = eng.stats()
            res[label] = dict(tokens=_tokens(outs), leaked=eng._pool.leaked(), in_use=eng._pool.in_use,
                              preemptions=stats["preemption"]["preemptions"],
                              swaps=stats["preemption"]["swaps"],
                              restores=stats["preemption"]["swap_restores"],
                              spec=stats["speculation"])
            if mesh is not None:
                res[label]["replicas_equal"] = _digests_equal(eng)
        out[name] = res
    return out


def drive_cancel_evacuate(model, sh, prompts):
    """JAX's zero-leak drill on the mesh: a resident cancel, an evacuation,
    then fresh traffic."""
    eng = _engine(model, sh, _cfg(max_new=8), kv_layout="paged", kv_block_size=4)
    reqs = [eng.submit(np.asarray(p, np.int32)) for p in prompts[:4]]
    for _ in range(3):
        eng.step()
    resident = [entry.req for entry in eng._active()]
    cancelled = eng.cancel(resident[0].request_id)
    first_status = resident[0].status
    eng.evacuate(cause="scale_down")
    pool = eng._pool
    after = dict(in_use=pool.in_use, reserved=pool.reserved, leaked=pool.leaked(),
                 causes=pool.stats()["frees_by_cause"], statuses=sorted({r.status for r in reqs}))
    outs = eng.serve([np.asarray(p, np.int32) for p in prompts[4:6]])
    return dict(resident=len(resident), cancelled=cancelled, first_status=first_status, after=after,
                again=_tokens(outs), final_in_use=pool.in_use, final_leaked=pool.leaked(),
                replicas_equal=_digests_equal(eng))


def setup_surfaces():
    """The 2x2 mesh, and a 1x4 one for the heads check (built here: group
    creation is collective)."""
    _spec(1, 4).resolve(device="cpu")
    return setup_2x2()


def drive_surfaces(model, sh):
    """Divisibility errors, the gauges with HELP, the coercions, the
    steady-state plans and warmup's step count against the unsharded
    engine's."""
    import torch.distributed as dist

    from perceiver_io_tpu_torch.observability.exporters import HELP_TEXT, to_prometheus_text
    from perceiver_io_tpu_torch.serving.sharding import as_serving_sharding

    out = {"errors": {}}
    for name, kwargs in (("slots", dict(slots=3, mesh=sh)),
                         ("heads", dict(slots=4, mesh=_spec(1, 4).resolve(device="cpu")))):
        try:
            _engine(model, cfg=_cfg(), **kwargs)
        except ValueError as e:
            out["errors"][name] = str(e)
    eng = _engine(model, sh, _cfg(), kv_layout="paged", kv_block_size=4)
    # put_state's slice of a whole state is the shard the engine allocated
    from perceiver_io_tpu_torch.serving.slots import _blank_state

    whole = _blank_state(model, eng.slots, 0, eng.device, pool_tokens=eng._state["pool_k"].shape[0])
    local = sh.put_state(whole)
    out["put_state"] = all(
        tuple(a.shape) == tuple(b.shape)
        for k in whole for a, b in zip(*(v[k] if isinstance(v[k], list) else [v[k]] for v in (local, eng._state))))
    try:
        eng.resize_slots(3)
    except ValueError as e:
        out["errors"]["resize"] = str(e)
    snap = eng.registry.snapshot()
    published = sorted(n for n in snap["gauges"] if n.startswith("serving_mesh_") or n.endswith("_per_shard"))
    text = to_prometheus_text(eng.registry)
    out["gauges"] = dict(published=published, missing_help=[n for n in published if n not in HELP_TEXT],
                         exported=all(f"# HELP {n} " in text for n in published))
    plain = _engine(model, None, _cfg())
    out["warmup"] = dict(plain=plain.warmup(), mesh=_engine(model, sh, _cfg()).warmup())
    before = sh.plans
    steady = _engine(model, sh, _cfg(max_new=4))
    built = sh.plans - before
    steady.serve([np.arange(1, 6, dtype=np.int32)])
    stats = steady.stats()
    out["steady"] = dict(plans=sh.plans - before - built, decode_steps=stats["decode_steps"],
                         prefills=stats["prefills"])
    out["coerce"] = dict(
        none=as_serving_sharding(None) is None, same=as_serving_sharding(sh) is sh,
        fingerprint=_identity(sh), describe=sh.describe(), world=dist.get_world_size())
    try:
        as_serving_sharding("2x2")
    except TypeError as e:
        out["coerce"]["type_error"] = str(e)
    return out


def setup_coercions():
    """Every rank: a 2x2 training mesh (coerced, its control group built
    here), an fsdp mesh (refused), and 1x2 specs over both halves."""
    from perceiver_io_tpu_torch.parallel import MeshConfig, make_mesh
    from perceiver_io_tpu_torch.serving import fleet_mesh_specs
    from perceiver_io_tpu_torch.serving.sharding import as_serving_sharding

    train = make_mesh(MeshConfig(data=2, fsdp=1, model=2, seq=1), device="cpu")
    coerced = as_serving_sharding(train)
    out = dict(sizes=[coerced.data_size, coerced.model_size], ranks=coerced.ranks)
    fsdp = make_mesh(MeshConfig(data=1, fsdp=2, model=2, seq=1), device="cpu")
    try:
        as_serving_sharding(fsdp)
    except ValueError as e:
        out["fsdp_error"] = str(e)
    a, b = (s.resolve(device="cpu") for s in fleet_mesh_specs(_spec(1, 2), 2))
    out.update(fingerprints=[_identity(a), _identity(b)],
               describes=[a.describe(), b.describe()])
    return out


def setup_allocator():
    from perceiver_io_tpu_torch.serving import MeshGroupAllocator

    return MeshGroupAllocator(_spec(1, 2), device="cpu")


def drive_bookkeeping(model, alloc):
    """``device_slice``, ``single_device_mesh``, ``fleet_mesh_specs`` and the
    allocator's claims (no engine)."""
    import gc

    from perceiver_io_tpu_torch.parallel.mesh import device_slice, single_device_mesh
    from perceiver_io_tpu_torch.serving import MeshGroupAllocator, ServingMeshSpec, fleet_mesh_specs

    out = dict(slices=[device_slice(4), device_slice(2, offset=2), device_slice(2, offset=1, ranks=[0, 1, 2, 3])],
               single=[single_device_mesh("cpu").ranks, single_device_mesh("cpu", index=3).ranks], errors={})
    for name, call in (("overrun", lambda: device_slice(4, offset=2)), ("count", lambda: device_slice(0)),
                       ("offset", lambda: device_slice(1, offset=-1)),
                       ("fleet_overrun", lambda: fleet_mesh_specs(_spec(1, 2), 3)),
                       ("fleet_zero", lambda: fleet_mesh_specs(_spec(1, 2), 0)),
                       ("axis", lambda: ServingMeshSpec(data=0, model=2)),
                       ("spec_offset", lambda: ServingMeshSpec(device_offset=-1))):
        try:
            call()
        except ValueError as e:
            out["errors"][name] = str(e)
    out["fleet_offsets"] = [s.device_offset for s in fleet_mesh_specs(_spec(1, 2), 2)]
    a, b = alloc.acquire(), alloc.acquire()
    claims = [a.spec.device_offset, b.spec.device_offset]
    del b
    gc.collect()
    c = alloc.acquire()
    d = alloc.acquire()
    claims += [c.spec.device_offset, d.spec.device_offset]
    # explicit release: deterministic, no gc (a second allocator over the
    # same groups builds none)
    alloc2 = MeshGroupAllocator(_spec(1, 2), device="cpu")
    a2, b2 = alloc2.acquire(), alloc2.acquire()
    a2.release()
    a2.release()
    claims += [alloc2.acquire().spec.device_offset, b2.spec.device_offset]
    out["claims"] = claims
    out["ranks"] = [a.ranks, c.ranks]
    return out


def drive_fleet(model, alloc, prompts):
    """Two 1x2 replicas through one allocator-backed factory, replica 0
    crashing at its second step: every request ends ok, the rebuild
    reclaims the crashed group, the groups stay disjoint."""
    from perceiver_io_tpu_torch.reliability import ChaosRegistry
    from perceiver_io_tpu_torch.serving import FleetRouter

    def factory():
        return _engine(model, alloc.acquire(), _cfg(max_new=6))

    chaos = ChaosRegistry()
    chaos.crash_replica(0, 2)
    fleet = FleetRouter([factory, factory], chaos=chaos)
    before = [r.engine.sharding.spec.device_offset for r in fleet.replicas]
    reqs = [fleet.submit(np.asarray(p, np.int32)) for p in prompts]
    fleet.run_until_idle()
    after = [r.engine.sharding.spec.device_offset for r in fleet.replicas]
    groups = [set(r.engine.sharding.ranks) for r in fleet.replicas]
    return dict(before=before, after=after, statuses=[r.status for r in reqs],
                tokens=[np.asarray(r.result).tolist() for r in reqs],
                restarts=fleet.stats()["replica_restarts"], disjoint=groups[0].isdisjoint(groups[1]),
                members=[sorted(g) for g in groups])


def setup_1x1():
    return _spec(1, 1).resolve(device="cpu")


def drive_byte_identity(model, sh, prompts):
    """The 1x1 mesh against the unsharded engine, dense and paged: tokens
    and the final state, leaf by leaf, as raw bytes."""
    import torch

    out = {}
    for name, kwargs in (("dense", {}), ("paged", dict(kv_layout="paged", kv_block_size=4))):
        ref = _engine(model, None, _cfg(), **kwargs)
        one = _engine(model, sh, _cfg(), **kwargs)
        outs_ref = ref.serve([np.asarray(p, np.int32) for p in prompts])
        outs_one = one.serve([np.asarray(p, np.int32) for p in prompts])

        def leaves(state):
            flat = {}
            for k, v in state.items():
                for i, t in enumerate(v if isinstance(v, list) else [v]):
                    flat[f"{k}/{i}"] = t.contiguous().view(torch.uint8).numpy().tobytes()
            return flat

        a, b = leaves(ref._state), leaves(one._state)
        out[name] = dict(tokens=_tokens(outs_ref), one_tokens=_tokens(outs_one), keys_equal=a.keys() == b.keys(),
                         mismatched=[k for k in a if a[k] != b.get(k)], mesh=one.stats()["mesh"])
    return out


def drive_cli(model, sh, ckpt, prompts_file):
    """``serve --serve.mesh.*`` through the port's CLI: the driver's lines
    (the other ranks run the same command and follow)."""
    from perceiver_io_tpu_torch.scripts.text import clm as clm_script

    rows = clm_script.main(_cli_argv(ckpt, prompts_file) + ["--serve.mesh.data=2", "--serve.mesh.model=2"])
    return [dict(completion=r["completion"], status=r["status"]) for r in rows]


def _cli_argv(ckpt, prompts_file):
    return ["serve", "--ckpt", ckpt, f"--serve.prompts={prompts_file}", "--serve.max_new_tokens=3",
            "--serve.num_latents=2", "--serve.prompt_buckets=16", "--serve.warmup=false",
            "--serve.engine=slots", "--serve.slots=2", "--device=cpu"]


def follow_cli(model, ckpt, prompts_file):
    from perceiver_io_tpu_torch.scripts.text import clm as clm_script

    return clm_script.main(_cli_argv(ckpt, prompts_file) + ["--serve.mesh.data=2", "--serve.mesh.model=2"])


def drive_probe(model, sh, argv):
    """The probe's JSON record (``python -m ...serving.sharding``)."""
    import contextlib
    import io
    import json

    from perceiver_io_tpu_torch.serving.sharding import _probe_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert _probe_main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _probe_follow(argv):
    from perceiver_io_tpu_torch.serving.sharding import _probe_main

    return _probe_main(argv)


SCENARIOS = {
    "parity": (setup_2x2, drive_parity),
    "twins": (setup_2x2, drive_unsharded_twins),
    "cancel_evacuate": (setup_2x2, drive_cancel_evacuate),
    "surfaces": (setup_surfaces, drive_surfaces),
    "coercions": (setup_coercions, None),
    "bookkeeping": (setup_allocator, drive_bookkeeping),
    "fleet": (setup_allocator, drive_fleet),
    "byte_identity": (setup_1x1, drive_byte_identity),
}


def serving(build, state_dict, scenarios):
    """Run ``scenarios`` (``[(name, kwargs)]``; ``name:label`` runs scenario
    ``name`` again under another key) in order in this rank; ``{name: the
    driver's result}`` on rank 0 (the setup's result for a scenario without a
    drive, on every rank)."""
    import torch.distributed as dist

    from perceiver_io_tpu_torch.serving import MeshGroupAllocator
    from perceiver_io_tpu_torch.serving.sharding import follow
    from tests._torch_port_parallel_worker import _model

    model = _model(build, state_dict).eval()
    rank = dist.get_rank()
    out = {}
    for key, kwargs in scenarios:
        name = key.split(":")[0]
        if name == "cli":  # every rank runs the command; rank 0's lines
            rows = drive_cli(model, None, **kwargs) if rank == 0 else follow_cli(model, **kwargs)
            out[key] = rows
            continue
        if name == "probe":  # every rank runs the probe; it follows on its own
            out[key] = drive_probe(model, None, **kwargs) if rank == 0 else _probe_follow(**kwargs)
            continue
        setup, drive = SCENARIOS[name]
        target = setup()
        if drive is None:
            out[key] = target
            continue
        if rank == 0:
            try:
                out[key] = drive(model, target, **kwargs)
            finally:
                if dist.get_world_size() > 1:
                    target.stop()
        elif isinstance(target, MeshGroupAllocator):
            target.follow(model)
        elif target.is_member:
            follow(target, model)
    return out

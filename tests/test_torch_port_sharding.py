"""The port's sharded serving runtime against the JAX package's, on the CPU:
JAX's ``tests/test_sharding.py``, test by test.

JAX serves its ``TINY`` model (vocab 89, context 32, 8 latents, 16
channels, 2 heads, 1 layer) through its ``SlotServingEngine`` unsharded and
on ``ServingMeshSpec(data=2, model=2)`` over the conftest's 8 virtual CPU
devices. The port serves the same weights (carried across by
``convert/from_jax.py``) on a 2x2 mesh of four gloo ranks
(``tests/_torch_port_parallel.py`` ``run_world``, one intra-op thread a
rank): rank 0 drives the engine and the others follow its plans
(``tests/_torch_port_sharding_cases.py``). One world of four and one world
of one run the module's scenarios.

Bars: greedy tokens equal to JAX's unsharded and sharded engines (exact
ids) in the dense, paged, chunked, paged+chunked and prefix-shared
geometries; a 1x1 mesh's tokens and final state equal to the port's
unsharded engine's, byte for byte; sampled decoding, swap preemption,
``k2d1`` speculation and an int8 chunked pool on the mesh equal to the
port's unsharded engine (exact ids; the sampled draws are the whole
batch's on every rank); every data replica of a pool byte-equal at the end;
JAX's error words; the allocator's and ``fleet_mesh_specs``' bookkeeping;
zero-leak cancel and evacuate; the fleet's crash rebuild on its crashed
group; the mesh gauges with HELP; the CLI's ``--serve.mesh.*``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests._torch_port_parallel import run_world
from perceiver_io_tpu.inference.generate import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.inference.samplers import SamplingConfig as JaxSamplingConfig
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.parallel.partition import serving_state_spec as jax_serving_state_spec
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import ServingMeshSpec as JaxServingMeshSpec
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu_torch.convert.from_jax import state_dict_from_jax
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModelConfig
from perceiver_io_tpu_torch.observability import report as report_mod
from perceiver_io_tpu_torch.parallel.partition import serving_state_spec

pytestmark = pytest.mark.timeout(600)

TINY = dict(vocab_size=89, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=1, cross_attention_dropout=0.0)
BUILD = ("perceiver_io_tpu_torch.models.text.clm", "CausalLanguageModel", CausalLanguageModelConfig(**TINY), {})
GEOMETRIES = {
    "dense": {},
    "paged": {"kv_layout": "paged", "kv_block_size": 4},
    "chunked": {"prefill_chunk": 8},
    "paged_chunked": {"kv_layout": "paged", "kv_block_size": 4, "prefill_chunk": 8},
}
PREFIX_KW = dict(kv_layout="paged", kv_block_size=4, prefill_chunk=8, prefix_cache="on")
TWINS = ("sampled", "swap", "spec_k2d1", "int8_chunked")


def _prompts(seed, lengths, vocab=89):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32) for n in lengths]


def _prefix_prompts():
    rng = np.random.default_rng(2)
    prefix = rng.integers(1, 89, size=8).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(1, 89, size=int(n)).astype(np.int32)]) for n in (3, 5, 7, 3)]


PARITY_PROMPTS = _prompts(1, [3, 11, 8, 3, 11])
IDENTITY_PROMPTS = _prompts(0, [3, 11, 8, 5])
DRILL_PROMPTS = _prompts(4, [5, 9, 7, 6]) + _prompts(5, [4, 8])
FLEET_PROMPTS = _prompts(6, [5, 9, 7, 6])
TWIN_PROMPTS = _prompts(7, [5, 11, 8, 12, 6, 9])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_model():
    model = JaxCLM(JaxCLMConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32), 8)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _jax_tokens(jax_model, prompts, max_new, mesh=None, **kwargs):
    model, params = jax_model
    cfg = JaxGenerationConfig(max_new_tokens=max_new, num_latents=2,
                              sampling=JaxSamplingConfig(temperature=0.0))
    table = JaxBucketTable(prompt_lens=(8, 16), batch_sizes=(1,))
    engine = JaxSlotServingEngine(model, params, cfg, table, slots=2, mesh=mesh, **kwargs)
    return [np.asarray(o).tolist() for o in engine.serve(prompts)]


@pytest.fixture(scope="module")
def jax_runs(jax_model):
    """JAX's unsharded and 2x2 tokens of every pinned geometry."""
    mesh = JaxServingMeshSpec(data=2, model=2)
    out = {}
    for name, kwargs in GEOMETRIES.items():
        out[name] = [_jax_tokens(jax_model, PARITY_PROMPTS, 8, m, **kwargs) for m in (None, mesh)]
    out["prefix"] = [_jax_tokens(jax_model, _prefix_prompts(), 6, m, **PREFIX_KW) for m in (None, mesh)]
    out["identity"] = [_jax_tokens(jax_model, IDENTITY_PROMPTS, 6, m) for m in (None, mesh)]
    return out


@pytest.fixture(scope="module")
def state_dict(jax_model):
    return {k: v.numpy() for k, v in state_dict_from_jax(jax_model[1]).items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, state_dict):
    """A port ``save_pretrained`` dir of the model at the CLI's vocab (262)."""
    import torch

    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel
    from perceiver_io_tpu_torch.training.checkpoint import save_pretrained

    root = tmp_path_factory.mktemp("sharding_cli")
    cfg = CausalLanguageModelConfig(**dict(TINY, vocab_size=262))
    save_pretrained(str(root / "ckpt"), CausalLanguageModel(cfg, seed=3, device="cpu"), cfg)
    (root / "prompts.txt").write_text("hello\nhi\n")
    torch.set_num_threads(1)
    return root


@pytest.fixture(scope="module")
def world4(tmp_path_factory, state_dict, ckpt):
    scenarios = [
        ("parity", dict(geometries=list(GEOMETRIES.items()), prompts=PARITY_PROMPTS, max_new=8)),
        ("parity:prefix", dict(geometries=[("prefix", PREFIX_KW)], prompts=_prefix_prompts(), max_new=6)),
        ("twins", dict(prompts=TWIN_PROMPTS)),
        ("cancel_evacuate", dict(prompts=DRILL_PROMPTS)),
        ("surfaces", {}),
        ("coercions", {}),
        ("bookkeeping", {}),
        ("fleet", dict(prompts=FLEET_PROMPTS)),
        ("cli", dict(ckpt=str(ckpt / "ckpt"), prompts_file=str(ckpt / "prompts.txt"))),
    ]
    job = [("serving", "serving", dict(build=BUILD, state_dict=state_dict, scenarios=scenarios))]
    ranks = run_world(tmp_path_factory.mktemp("sharding4"), 4, job, timeout=500)
    return ranks


@pytest.fixture(scope="module")
def driver(world4):
    return world4[0]["serving"]


@pytest.fixture(scope="module")
def world1(tmp_path_factory, state_dict):
    job = [("serving", "serving", dict(build=BUILD, state_dict=state_dict,
                                       scenarios=[("byte_identity", dict(prompts=IDENTITY_PROMPTS))]))]
    return run_world(tmp_path_factory.mktemp("sharding1"), 1, job, timeout=300)[0]["serving"]["byte_identity"]


# -- rank-subset plumbing ----------------------------------------------------
def test_device_slice_and_single_device_mesh_subsets(driver):
    book = driver["bookkeeping"]
    assert book["slices"] == [[0, 1, 2, 3], [2, 3], [1, 2]]
    assert "overruns" in book["errors"]["overrun"]
    assert "count must be >= 1" in book["errors"]["count"]
    assert "offset must be >= 0" in book["errors"]["offset"]
    assert book["single"] == [[0], [3]]


def test_fleet_mesh_specs_disjoint_and_budget(driver):
    book = driver["bookkeeping"]
    assert book["fleet_offsets"] == [0, 2]
    assert "overruns" in book["errors"]["fleet_overrun"]
    assert "replicas must be >= 1" in book["errors"]["fleet_zero"]
    # two live claims; the released group is reclaimed, then a wrap; an
    # explicit release frees its group at once, the live claim untouched
    a, b, c, d, again, live = book["claims"]
    assert (a, b, c) == (0, 2, 2) and d in (0, 2) and (again, live) == (0, 2)
    assert book["ranks"] == [[0, 1], [2, 3]]
    assert "axis sizes must be >= 1" in book["errors"]["axis"]
    assert "device_offset must be >= 0" in book["errors"]["spec_offset"]


def test_serving_state_rules():
    """The serving rules equal JAX's on the names and shapes JAX pins."""
    sizes = {"data": 2, "fsdp": 1, "model": 2, "seq": 1}
    jax_mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 1, 2, 1),
                                 ("data", "fsdp", "model", "seq"))
    cases = [("pool_k", (64, 2, 8)), ("pool_v", (64, 2, 8)), ("cross_k", (2, 2, 32, 8)),
             ("stack_k/0", (2, 2, 8, 8)), ("stage_k", (1, 2, 32, 8)), ("window", (2, 32)),
             ("table", (2, 9)), ("length", (2,)), ("cross_k", (3, 2, 32, 8)), ("pool_k", (64, 3, 8)),
             ("mystery", (4, 4))]
    for name, shape in cases:
        assert tuple(serving_state_spec(name, shape, sizes)) == tuple(jax_serving_state_spec(name, shape, jax_mesh))


def test_as_serving_sharding_coercion(driver, world4):
    co, surfaces = driver["coercions"], driver["surfaces"]["coerce"]
    assert surfaces["none"] and surfaces["same"]
    assert surfaces["fingerprint"] == ["mesh", 2, 2, [0, 1, 2, 3]]
    assert co["sizes"] == [2, 2] and co["ranks"] == [0, 1, 2, 3]
    assert "no optimizer state" in co["fsdp_error"]
    assert "mesh must be" in surfaces["type_error"]
    # same geometry on disjoint rank groups: different identity
    assert co["fingerprints"][0] != co["fingerprints"][1]
    assert co["describes"] == ["1x2@2dev+0", "1x2@2dev+2"]
    # every rank built the same groups
    assert all(r["serving"]["coercions"] == co for r in world4)


# -- divisibility validation -------------------------------------------------
def test_divisibility_validation(driver):
    # the shard each rank allocates is put_state's slice of the whole state
    assert driver["surfaces"]["put_state"]
    errors = driver["surfaces"]["errors"]
    assert re.search(r"slots .3. must divide", errors["slots"])
    assert re.search(r"heads .2. must divide", errors["heads"])
    assert "must divide evenly" in errors["resize"]


# -- exactness: the 1x1 mesh's bytes ---------------------------------------------
def test_one_device_mesh_byte_identity(world1, jax_runs):
    for name, rec in world1.items():
        assert rec["one_tokens"] == rec["tokens"]
        assert rec["keys_equal"] and not rec["mismatched"], f"{name}: leaves diverged: {rec['mismatched']}"
        assert rec["mesh"] == {"data": 1, "model": 1, "devices": 1, "spec": "1x1@1dev+0"}
    # and the dense run's tokens are JAX's (unsharded and 2x2)
    assert world1["dense"]["tokens"] == jax_runs["identity"][0] == jax_runs["identity"][1]


# -- exactness: the 2x2 mesh's tokens ---------------------------------------------
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_parity_token_identity(driver, jax_runs, geometry):
    rec = driver["parity"][geometry]
    plain, sharded = jax_runs[geometry]
    assert rec["tokens"] == plain == sharded
    assert rec["completed"] == len(PARITY_PROMPTS)
    assert rec["mesh"]["devices"] == 4 and rec["health_mesh"] == rec["describe"] == "2x2@4dev+0"
    g = rec["gauges"]
    assert (g["serving_mesh_devices"], g["serving_mesh_data"], g["serving_mesh_model"]) == (4, 2, 2)
    if "kv_layout" in GEOMETRIES[geometry]:
        assert rec["in_use"] == 0 and rec["leaked"] == 0
        assert g["kv_cache_resident_bytes_per_shard"] == g["kv_cache_resident_bytes"] // 2


def test_sharded_parity_prefix_shared(driver, jax_runs):
    rec = driver["parity:prefix"]["prefix"]
    plain, sharded = jax_runs["prefix"]
    assert rec["tokens"] == plain == sharded
    assert rec["hits"] > 0
    assert rec["leaked"] == 0 and rec["in_use"] == rec["gauges"]["kv_prefix_cached_blocks"]


# -- the port's sharded engine against its unsharded engine -------------------
@pytest.mark.parametrize("name", TWINS)
def test_sharded_twins_match_the_unsharded_engine(driver, name):
    run = driver["twins"][name]
    assert run["mesh"]["tokens"] == run["plain"]["tokens"]
    assert run["mesh"]["leaked"] == run["plain"]["leaked"] == 0
    assert run["mesh"]["in_use"] == run["plain"]["in_use"] == 0
    if name == "swap":  # the drill ran: victims swapped out and restored
        assert run["mesh"]["swaps"] > 0 and run["mesh"]["restores"] == run["mesh"]["swaps"]
        assert (run["mesh"]["preemptions"], run["mesh"]["swaps"]) == (run["plain"]["preemptions"],
                                                                      run["plain"]["swaps"])
    if name == "spec_k2d1":
        assert run["mesh"]["spec"] == run["plain"]["spec"] and run["mesh"]["spec"]["rounds"] > 0


@pytest.mark.parametrize("run", ["paged", "paged_chunked", "prefix", *TWINS, "cancel_evacuate"])
def test_data_replicas_of_the_pool_are_byte_equal(driver, run):
    if run in TWINS:
        rec = driver["twins"][run]["mesh"]
    elif run == "cancel_evacuate":
        rec = driver["cancel_evacuate"]
    elif run == "prefix":
        rec = driver["parity:prefix"]["prefix"]
    else:
        rec = driver["parity"][run]
    assert rec["replicas_equal"]


# -- executor identity -----------------------------------------------------------
def test_compile_bound_and_zero_steady_state_retrace(driver):
    """Nothing compiles per shape in the port: warmup drives the unsharded
    engine's steps, and steady-state traffic sends one plan a device op
    (a prefill an admission, a decode a step: nothing is replayed)."""
    s = driver["surfaces"]
    assert s["warmup"]["mesh"] == s["warmup"]["plain"] == 2 + 2
    assert s["steady"]["plans"] == s["steady"]["prefills"] + s["steady"]["decode_steps"] > 0


def test_mesh_in_cache_key_and_ledger_attribution(driver):
    """The mesh's identity (no executor cache to key): axis sizes and the
    concrete ranks; disjoint groups of one geometry differ."""
    co = driver["coercions"]
    assert co["fingerprints"] == [["mesh", 1, 2, [0, 1]], ["mesh", 1, 2, [2, 3]]]
    assert driver["surfaces"]["coerce"]["describe"] == "2x2@4dev+0"


# -- zero leaks ---------------------------------------------------------------------
def test_sharded_cancel_and_evacuate_zero_leak(driver):
    rec = driver["cancel_evacuate"]
    assert rec["resident"] and rec["cancelled"] and rec["first_status"] == "cancelled"
    after = rec["after"]
    assert after["in_use"] == after["reserved"] == after["leaked"] == 0
    assert after["causes"].get("cancelled", 0) > 0 and after["statuses"] == ["cancelled"]
    assert all(len(t) for t in rec["again"])
    assert rec["final_in_use"] == rec["final_leaked"] == 0


# -- observability -------------------------------------------------------------------
def test_report_sharding_section_fixture_pinned():
    text = report_mod.run("tests/fixtures/events.jsonl", "tests/fixtures/metrics_snapshot.json")
    assert "== sharded serving ==" in text
    assert "mesh: 2x2 over 4 devices" in text
    assert "1,536 B per model shard" in text
    assert "ledger meshes: 2x2@4dev+0" in text
    analysis = report_mod.analyze([], {
        "gauges": {"serving_mesh_devices": 4, "serving_mesh_data": 2, "serving_mesh_model": 2,
                   "kv_cache_resident_bytes": 2048, "kv_cache_resident_bytes_per_shard": 1024},
        "counters": {},
    })
    assert analysis["sharding"]["per_shard_resident_bytes"] == 1024
    assert analysis["sharding"]["mesh_retraces"] is None
    empty = report_mod.analyze([], {})
    assert empty["sharding"] is None
    assert "== sharded serving ==" not in report_mod.format_report(empty)


def test_fleet_crash_rebuild_reclaims_crashed_group(driver):
    rec = driver["fleet"]
    assert rec["before"] == rec["after"] == [0, 2]
    assert rec["statuses"] == ["ok"] * len(FLEET_PROMPTS) and all(rec["tokens"])
    assert rec["restarts"] == 1
    assert rec["disjoint"] and rec["members"] == [[0, 1], [2, 3]]


def test_mesh_metric_families_have_help(driver):
    g = driver["surfaces"]["gauges"]
    assert g["published"] == ["kv_cache_resident_bytes_per_shard", "serving_mesh_data",
                              "serving_mesh_devices", "serving_mesh_model"]
    assert not g["missing_help"] and g["exported"]


# -- the CLI flag group -----------------------------------------------------------------
def test_serve_cli_mesh_flag_group(driver, ckpt):
    from perceiver_io_tpu_torch.scripts.text import clm as clm_script

    common = ["serve", "--ckpt", str(ckpt / "ckpt"), f"--serve.prompts={ckpt}/prompts.txt",
              "--serve.max_new_tokens=3", "--serve.num_latents=2", "--serve.prompt_buckets=16",
              "--serve.warmup=false", "--serve.engine=slots", "--serve.slots=2", "--device=cpu"]
    plain = clm_script.main(common)
    sharded = driver["cli"]
    assert [r["completion"] for r in sharded] == [r["completion"] for r in plain]
    assert all(r["status"] == "ok" for r in sharded)
    with pytest.raises(SystemExit, match="applies to --serve.engine=slots"):
        clm_script.main([a for a in common if not a.startswith(("--serve.engine", "--serve.slots"))]
                        + ["--serve.engine=bucket", "--serve.mesh.model=2"])
    with pytest.raises(SystemExit, match="overruns"):
        clm_script.main(common + ["--serve.mesh.data=2", "--serve.mesh.model=2", "--serve.replicas=3"])


# -- the probe --------------------------------------------------------------------------
@pytest.mark.slow  # its own world of four; the smoke's shard phase is its lane on the card
def test_shard_probe_main_records(tmp_path, state_dict):
    argv = ["--data", "2", "--model", "2", "--slots", "2", "--requests", "4", "--new-tokens", "4",
            "--kv-layout", "paged", "--device", "cpu"]
    job = [("serving", "serving", dict(build=BUILD, state_dict=state_dict, scenarios=[("probe", dict(argv=argv))]))]
    record = run_world(tmp_path, 4, job, timeout=300)[0]["serving"]["probe"]
    assert record["mesh"] == {"data": 2, "model": 2}
    assert record["kv_layout"] == "paged"
    assert record["tokens_per_s"] > 0 and record["warmup_steps"] > 0
    assert len(record["tokens"]) == 4 and all(record["tokens"])
    assert record["per_shard_resident_bytes"] * 2 <= record["resident_bytes"] + 1

"""The port's model-to-database bridge (``repro_torch.models.lowering``),
``ops.matmul`` and the engine's ``tuning_db``/``explain_kernels`` against the
reference's ``repro.models.lowering``, ``repro.kernels.ops`` and
``repro.serve.ServingEngine``, on the CPU.

Plans are configuration only: they are compared field for field at the
published widths of all 10 architectures, against a fresh database and
against ``data/pretuned_xla.json`` loaded by each package's own
``TuningDatabase.load``.  Both packages run in one process, so the
reference's authoring order (``hash(name) % 2``) is the same in both.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_config
from repro.core.database import TuningDatabase as RTuningDatabase
from repro.core.database import default_pretuned_path as r_default_path
from repro.kernels import ops as r_ops
from repro.models import lowering as RL
from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServingEngine as RServingEngine
from repro_torch.autotune import NestTelemetry
from repro_torch.configs import get_config as p_config
from repro_torch.core.database import TuningDatabase, default_pretuned_path
from repro_torch.kernels import gemm as p_gemm
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lowering as PL
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine

torch.set_num_threads(1)
SEQ, BATCH = 4096, 8


@functools.cache
def _xla_dbs():
    """data/pretuned_xla.json, loaded by each package (never mutated here)."""
    return (RTuningDatabase.load(r_default_path("xla")),
            TuningDatabase.load(default_pretuned_path("xla")))


def _fields(plans):
    return [(p.name, tuple(p.mnk), p.fingerprint, p.idiom, p.recipe.kind,
             None if p.recipe.tile is None else tuple(p.recipe.tile), p.source, p.mesh_axis)
            for p in plans]


def _plan_rows(report: str) -> list[str]:
    lines = report.splitlines()
    return [lines[0]] + lines[lines.index("contraction plans:"):]


@pytest.mark.parametrize("db", ["fresh", "pretuned_xla"])
@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_plans_match_reference(arch, db):
    rcfg, pcfg = r_config(arch), p_config(arch)
    assert PL.model_contractions(pcfg, SEQ, BATCH) == RL.model_contractions(rcfg, SEQ, BATCH)
    rdb, pdb = _xla_dbs() if db == "pretuned_xla" else (None, None)
    rgen, pgen = (rdb.generation, pdb.generation) if rdb is not None else (0, 0)
    want = RL.plan_model(rcfg, SEQ, BATCH, db=rdb)
    got = PL.plan_model(pcfg, SEQ, BATCH, db=pdb)
    assert _fields(got) == _fields(want)
    assert all(p.idiom == "blas3" for p in got)
    if rdb is not None:  # a loaded database is read, not seeded
        assert (rdb.generation, pdb.generation) == (rgen, pgen)


def test_seed_model_database_matches_reference():
    rdb, pdb = RTuningDatabase(), TuningDatabase()
    RL.seed_model_database(rdb)
    PL.seed_model_database(pdb)
    (re,), (pe,) = rdb.entries, pdb.entries
    assert pe.fingerprint == re.fingerprint
    np.testing.assert_array_equal(pe.embedding, re.embedding)
    assert (pe.recipe.kind, tuple(pe.recipe.tile), pe.provenance) == \
        (re.recipe.kind, tuple(re.recipe.tile), re.provenance)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x7b", "seamless-m4t-large-v2"])
def test_kernel_report_plan_rows_match_reference(arch):
    """The per-pass table carries times; its header and the plan rows do not."""
    want = RL.kernel_report(r_config(arch).reduced(), seq=64, batch=2)
    got = PL.kernel_report(p_config(arch).reduced(), seq=64, batch=2)
    assert _plan_rows(got) == _plan_rows(want)
    assert "canonical_rename" in got and "q_proj" in got and "lm_head" in got


def test_pick_tile_matches_reference():
    for mnk in [(8, 8, 8), (64, 4096, 4096), (32768, 128, 4096), (2048, 32000, 4096),
                (640, 14336, 4096), (100, 300, 200)]:
        assert PL._pick_tile(*mnk) == RL._pick_tile(*mnk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_matmul_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 70)).astype(np.float32)
    y = rng.standard_normal((70, 53)).astype(np.float32)
    tx, ty = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(y).to(
        getattr(torch, dtype))
    want = np.asarray(r_ops.matmul(jnp.asarray(tx.float().numpy()).astype(dtype),
                                   jnp.asarray(ty.float().numpy()).astype(dtype),
                                   backend="xla").astype(jnp.float32))
    before = p_gemm.PLAIN["gemm"]
    got = ops.matmul(tx, ty, tile=(256, 256, 128))
    assert got.dtype == tx.dtype and p_gemm.PLAIN["gemm"] == before + 1
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else dict(rtol=5e-2, atol=5e-1)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert torch.equal(ops.matmul(tx, ty), got)  # the tile is ignored


def test_ops_matmul_refuses_what_k1_does_not_take():
    with pytest.raises(ValueError):
        ops.matmul(torch.ones(2, 3, 4), torch.ones(4, 5))
    with pytest.raises(TypeError):
        ops.matmul(torch.ones(2, 3, dtype=torch.float64), torch.ones(3, 4, dtype=torch.float64))


class _FakeMesh:
    """A mesh's axis sizes, with no world."""

    def __init__(self, shape):
        self.shape, self.axis_names = shape, tuple(shape)


def test_deployment_context():
    cfg = p_config("minicpm-2b").reduced()
    params = {"embed": torch.zeros(2)}
    ctx = PL.deployment_context(cfg, params)
    assert ctx.params is params and ctx.place(params) is params
    assert ctx.tuning_db is PL.deployment_database() is PL.deployment_database("cuda")
    assert isinstance(ctx.telemetry, NestTelemetry) and not ctx.telemetry.enabled
    built = []
    make = lambda: built.append(1) or object()  # noqa: E731
    first = ctx.jitted("test.lowering", make, 7)
    assert PL.deployment_context(cfg, params).jitted("test.lowering", make, 7) is first
    assert built == [1]
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    placed = PL.deployment_context(cfg, dict(params), mesh=mesh)  # a mesh of one: as it is
    assert placed.params["embed"] is params["embed"] and placed.mesh is mesh
    jamba = p_config("jamba-1.5-large-398b").reduced()
    with pytest.raises(NotImplementedError, match="3a-iii"):
        PL.deployment_context(jamba, params, mesh=_FakeMesh({"data": 1, "model": 2}))


def test_deployment_database_holds_the_pretuned_file_and_the_seed():
    db = PL.deployment_database("cuda")
    shipped = TuningDatabase.load(default_pretuned_path("cuda"))
    seed = TuningDatabase()
    PL.seed_model_database(seed)
    fps = {e.fingerprint for e in db.entries}
    assert {e.fingerprint for e in shipped.entries} | {seed.entries[0].fingerprint} == fps


def test_telemetry_matches_reference():
    from repro.autotune import NestTelemetry as RNestTelemetry

    r, p = RNestTelemetry(alpha=0.5), NestTelemetry(alpha=0.5)
    for key, secs in [("a", 1.0), ("b", 3.0), ("a", 2.0), ("a", 4.0)]:
        r.observe(key, secs)
        p.observe(key, secs)
    assert p.snapshot() == r.snapshot()
    assert p.hottest(2) == r.hottest(2) and p.ema("a") == r.ema("a") and p.count("b") == 1
    p.reset("a")
    assert p.ema("a") is None and p.count("a") == 0
    off = NestTelemetry(enabled=False)
    off.observe("a", 1.0)
    assert off.snapshot() == {}


@pytest.fixture(scope="module")
def minicpm():
    rcfg, pcfg = r_config("minicpm-2b").reduced(), p_config("minicpm-2b").reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    return rcfg, rparams, pcfg, pparams


def test_explain_kernels_matches_reference_engine(minicpm):
    """The port's default database (data/pretuned_cuda.json + the model seed)
    against the reference engine given the same file, loaded and seeded by
    the reference; the shared instance is left as it was."""
    rcfg, rparams, pcfg, pparams = minicpm
    rdb = RTuningDatabase.load(default_pretuned_path("cuda"))
    RL.seed_model_database(rdb)
    shared = PL.deployment_database()
    gen, n = shared.generation, len(shared.entries)
    want = RServingEngine(rcfg, rparams, RServeConfig(max_len=32),
                          tuning_db=rdb).explain_kernels()
    eng = ServingEngine(pcfg, pparams, ServeConfig(max_len=32))
    assert eng.tuning_db is shared
    assert _plan_rows(eng.explain_kernels()) == _plan_rows(want)
    assert (shared.generation, len(shared.entries)) == (gen, n)


def test_explain_kernels_is_cached_until_the_database_changes(minicpm):
    _, _, pcfg, pparams = minicpm
    db = TuningDatabase()
    PL.seed_model_database(db)
    eng = ServingEngine(pcfg, pparams, ServeConfig(max_len=32), tuning_db=db)
    assert eng.tuning_db is db and not eng.telemetry.enabled
    rep = eng.explain_kernels()
    assert "contraction plans:" in rep
    assert ServingEngine(pcfg, pparams, ServeConfig(max_len=32),
                         tuning_db=db).explain_kernels() is rep
    e = db.entries[0]
    db.add(e.fingerprint + "x", e.embedding, e.recipe, provenance="test")  # bumps the generation
    assert eng.explain_kernels() is not rep


def test_engine_takes_tuning_db_and_still_refuses_mesh(minicpm):
    rcfg, rparams, pcfg, pparams = minicpm
    db = TuningDatabase()
    kw = dict(batch_slots=2, max_len=32, max_new_tokens=4)
    prompts = [np.array([3, 1, 4], np.int32), np.array([9, 8], np.int32)]
    eng = ServingEngine(pcfg, pparams, ServeConfig(**kw), tuning_db=db)
    hs = [eng.submit(p) for p in prompts]
    eng.drain()
    reng = RServingEngine(rcfg, rparams, RServeConfig(**kw), tuning_db=RTuningDatabase())
    rhs = [reng.submit(p) for p in prompts]
    reng.drain()
    assert [h.tokens for h in hs] == [h.tokens for h in rhs]
    with pytest.raises(NotImplementedError, match="mesh"):  # the tuner, under ranks
        ServingEngine(pcfg, pparams, ServeConfig(), tuning_db=db, tuner=object(),
                      mesh=_FakeMesh({"data": 1, "model": 2}))

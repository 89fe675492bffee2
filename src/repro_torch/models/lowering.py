"""The model-to-database bridge (port of ``repro/models/lowering.py``).

Each architecture's core per-layer contractions (QKV/O projections, FFN
matmuls, expert FFN, attention score/value contractions) are expressed as
loop-nest IR programs, normalized, and resolved against the transfer-tuning
database, mirroring the paper's flow: normalization first, then a small
recipe set covers every layer of every architecture.  Because all 10 archs'
contractions normalize onto the same canonical GEMM fingerprint family, the
database stays tiny.

A plan is a record, not a dispatch: the models compute their projections as
``x @ w`` (cuBLAS), as the reference computes them outside any Pallas
kernel, and ``kernels.ops.matmul`` (K1) ignores a recipe's tile.  The tiles
kept in a plan are the reference's TPU presets (``recipes.GEMM_TILE_PRESETS``,
sized for a 16 MB VMEM), so both packages give the same plan field for field.

``deployment_database`` and ``deployment_context`` give ``ServingEngine``
its database, its content-keyed build cache and its telemetry sink, and
under a mesh place the parameters with the sharding planner's specs
(``launch.sharding``).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig
from ..core.database import TuningDatabase
from ..core.embedding import embed_nest
from ..core.fusion import optimization_pipeline
from ..core.idioms import classify_nest
from ..core.ir import Array, Computation, Loop, Program, acc, fingerprint
from ..core.passes import PassContext
from ..core.recipes import GEMM_TILE_PRESETS, Recipe

# The same pass pipeline the daisy scheduler runs (normalization +
# canonical-form re-fusion); single-contraction programs pass through the
# fusion stage untouched (blas3 nests stay standalone library calls), but
# sharing the instance keeps model fingerprints aligned with Daisy's.
PIPELINE = optimization_pipeline(fuse=True)


def _matmul_program(name: str, m: int, n: int, k: int, order=("i", "j", "k")) -> Program:
    mac = Computation(
        "mac", acc("Y", "i", "j"), (acc("X", "i", "k"), acc("W", "k", "j")),
        lambda x, w: x * w, accumulate="+",
    )
    dims = {"i": m, "j": n, "k": k}
    nest: tuple = (mac,)
    for it in reversed(order):
        nest = (Loop(it, dims[it], body=nest),)
    return Program(
        name,
        (Array("X", (m, k)), Array("W", (k, n)), Array("Y", (m, n))),
        nest,
    )


@dataclass(frozen=True)
class ContractionPlan:
    name: str
    mnk: tuple[int, int, int]
    fingerprint: str
    idiom: str
    recipe: Recipe
    source: str
    mesh_axis: str  # proposed sharded axis for the parallel loop


def _pick_tile(m: int, n: int, k: int) -> tuple[int, int, int]:
    """The reference's VMEM-aligned tile: grow M/N while the working set
    stays under ~8MB (double-buffered halves of a 16MB VMEM)."""
    best = GEMM_TILE_PRESETS[0]
    budget = 8 * 1024 * 1024
    for bm, bn, bk in GEMM_TILE_PRESETS:
        if bm > m or bn > n or bk > k:
            continue
        ws = 4 * (bm * bk + bk * bn + bm * bn)  # fp32 working set
        if ws <= budget and bm * bn >= best[0] * best[1]:
            best = (bm, bn, bk)
    return best


def model_contractions(cfg: ModelConfig, seq: int, batch: int) -> dict[str, tuple[int, int, int]]:
    """(M, N, K) of each distinct per-layer contraction at a given shape."""
    t = seq * batch  # token count (the parallel M dimension)
    d, h, kv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    out: dict[str, tuple[int, int, int]] = {
        "q_proj": (t, h * dh, d),
        "kv_proj": (t, kv * dh, d),
        "o_proj": (t, d, h * dh),
        "lm_head": (t, cfg.vocab, d),
    }
    if f:
        if cfg.is_moe:
            from .layers import moe_capacity

            c = moe_capacity(cfg, t)
            out["expert_ffn_in"] = (c, f, d)   # per expert
            out["expert_ffn_out"] = (c, d, f)
        else:
            out["ffn_in"] = (t, f, d)
            out["ffn_out"] = (t, d, f)
    if cfg.family == "hybrid":
        din = cfg.mamba_expand * d
        out["mamba_in_proj"] = (t, 2 * din, d)
        out["mamba_out_proj"] = (t, d, din)
    win = cfg.window or seq
    out["attn_scores"] = (seq, min(win, seq), dh)  # per (batch, head)
    out["attn_values"] = (seq, dh, min(win, seq))
    return out


def seed_model_database(db: TuningDatabase) -> None:
    """Seed the DB with the canonical GEMM recipe (fingerprint-generic via
    the embedding metric: every model contraction normalizes to this family)."""
    probe = _matmul_program("canonical_gemm", 1024, 1024, 1024)
    norm = PIPELINE.run(probe)
    nest = norm.body[0]
    db.add(
        fingerprint(nest),
        embed_nest(norm, nest),
        Recipe(kind="pallas_gemm", tile=(256, 256, 128), notes="canonical GEMM"),
        provenance="model-seed",
    )


_DEPLOYMENT_DBS: dict[str, TuningDatabase] = {}


def deployment_database(backend: str = "cuda") -> TuningDatabase:
    """The database a deployment starts from.

    The shipped pretuned transfer database (``data/pretuned_<backend>.json``,
    written on the card by ``repro_torch.tools.tune``) when installed, plus
    the canonical-GEMM model seed on top (``add`` never downgrades a measured
    entry).

    One *shared* instance per backend: re-created engines resolve against the
    same object, so content-keyed caches (kernel reports) hit across
    instances; seeding it with new recipes bumps its generation and expires
    those caches coherently.
    """
    from ..core.database import try_load_pretuned

    db = _DEPLOYMENT_DBS.get(backend)
    if db is None:
        db = try_load_pretuned(backend) or TuningDatabase()
        seed_model_database(db)
        _DEPLOYMENT_DBS[backend] = db
    return db


@dataclass
class DeploymentContext:
    """What ``ServingEngine`` needs before its first step: the parameters, a
    tuning database (the shared ``deployment_database`` unless the caller
    stages one), a content-keyed build cache, and a telemetry sink.  Build
    it with ``deployment_context``."""

    cfg: ModelConfig
    tuning_db: TuningDatabase
    params: object
    # Live step-timing sink (``repro_torch.autotune.NestTelemetry``); a
    # disabled instance by default, so engines can observe unconditionally.
    telemetry: object = None
    mesh: object = None
    _specs: object = None

    def place(self, tree):
        """A full parameter-shaped tree (e.g. optimizer moments) cut with the
        specs ``params`` were placed with (in place, like
        ``sharding.shard_params``); the identity without a mesh."""
        if self._specs is None:
            return tree
        from ..launch.sharding import shard_params

        return shard_params(tree, self._specs, self.mesh)

    def jitted(self, name: str, build, *key_parts):
        """Whatever ``build()`` returns, from the shared content-addressed
        cache keyed on ``name``, the config fingerprint and ``key_parts``:
        equal-config deployments share it (torch runs eagerly, so there is
        no trace to share, only the built value)."""
        from ..core.cache import fingerprint_obj, jit_cache

        return jit_cache.get_or_build(
            (name, fingerprint_obj(self.cfg), *key_parts), build
        )


def deployment_context(
    cfg: ModelConfig,
    params,
    mesh=None,
    tuning_db: TuningDatabase | None = None,
    telemetry=None,
) -> DeploymentContext:
    """Resolve the deployment-time context: place the full ``params`` on
    ``mesh`` (any mesh of ``launch.mesh`` over the planner's axes) with
    ``launch.sharding.param_specs``, cutting the tree in place to this
    rank's shards, pick the tuning database (caller-staged, else the shared
    ``deployment_database`` instance) and attach a telemetry sink
    (caller-staged, else a disabled one).  The ``hybrid``, ``ssm`` and
    ``audio`` families have no rules under a ``model`` axis of more than one
    rank yet (ROADMAP queue 1, item 6, step 3a-iii) and raise there."""
    db = tuning_db if tuning_db is not None else deployment_database()
    specs = None
    if mesh is not None:
        from ..launch.sharding import param_specs, shard_params

        if cfg.family in ("hybrid", "ssm", "audio") and mesh.shape.get("model", 1) > 1:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family under a model axis of "
                f"{mesh.shape['model']} ranks is not ported yet (the mamba, xLSTM and "
                "cross-attention rules: ROADMAP queue 1, item 6, step 3a-iii)")
        specs = param_specs(params, mesh, cfg=cfg)
        params = shard_params(params, specs, mesh)
    if telemetry is None:
        from ..autotune import NestTelemetry

        telemetry = NestTelemetry(enabled=False)
    return DeploymentContext(cfg, db, params, telemetry, mesh, specs)


def plan_model(cfg: ModelConfig, seq: int, batch: int,
               db: TuningDatabase | None = None) -> list[ContractionPlan]:
    db = db or TuningDatabase()
    if not db.entries:
        seed_model_database(db)
    plans = []
    for name, (m, n, k) in model_contractions(cfg, seq, batch).items():
        # author the nest in an arbitrary (developer-chosen) order; the
        # normalizer canonicalizes it before the DB lookup
        order = ("k", "i", "j") if hash(name) % 2 else ("i", "j", "k")
        prog = PIPELINE.run(_matmul_program(name, m, n, k, order))
        nest = prog.body[0]
        fp = fingerprint(nest)
        emb = embed_nest(prog, nest)
        idiom = classify_nest(nest)
        recipe, source = db.lookup(fp, emb)
        if recipe is None:
            recipe = Recipe(kind="pallas_gemm", tile=_pick_tile(m, n, k))
            source = "default(blas3)"
        if recipe.tile is None or recipe.tile[0] > m or recipe.tile[1] > n:
            recipe = Recipe(kind=recipe.kind, tile=_pick_tile(m, n, k), notes=recipe.notes)
        mesh_axis = "model" if name in ("expert_ffn_in", "expert_ffn_out") else (
            "data" if m >= n else "model"
        )
        plans.append(ContractionPlan(name, (m, n, k), fp, idiom.kind, recipe, source, mesh_axis))
    return plans


def kernel_report(cfg: ModelConfig, seq: int, batch: int,
                  db: TuningDatabase | None = None,
                  plans: list[ContractionPlan] | None = None) -> str:
    """Human-readable pass-pipeline + per-contraction plan report.

    Rendered by the serving engine's ``explain_kernels``: one per-pass table
    for the largest contraction (they all walk the same pipeline) plus one
    plan row per contraction.  Callers that already ran ``plan_model`` pass
    its result via ``plans``.
    """
    if plans is None:
        plans = plan_model(cfg, seq, batch, db=db)
    name, (m, n, k) = max(
        model_contractions(cfg, seq, batch).items(),
        key=lambda kv: kv[1][0] * kv[1][1] * kv[1][2],
    )
    ctx = PassContext()
    PIPELINE.run(_matmul_program(name, m, n, k), ctx=ctx)
    lines = [
        f"pass pipeline ({PIPELINE.name}) on {name} [{m}x{n}x{k}]:",
        ctx.report(),
        "",
        "contraction plans:",
    ]
    for p in plans:
        m, n, k = p.mnk
        lines.append(
            f"  {p.name:<16} {m:>8}x{n:<8}x{k:<6} idiom={p.idiom} "
            f"recipe={p.recipe.kind}{f' tile={p.recipe.tile}' if p.recipe.tile else ''} "
            f"source={p.source} axis={p.mesh_axis}"
        )
    return "\n".join(lines)

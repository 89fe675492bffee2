"""repro_torch.core — a priori loop nest normalization + the daisy
auto-scheduler, lowered to torch (port of ``repro.core``).

Public API:
    ir          — the affine loop-nest IR (Program/Loop/Computation/Access)
    passes      — the compiler pass pipeline (Pass/PassPipeline/PassContext)
    normalize   — maximal loop fission + stride minimization (paper §2)
    fusion      — canonical-form re-fusion of adjacent elementwise nests
    codegen     — executable lowerings (numpy oracle, as-written, canonical)
    tiling      — the nest kernel's grid planner
    scheduler   — Daisy: pipeline -> idioms -> transfer-tune -> compile
"""
from .ir import (  # noqa: F401
    Access,
    Affine,
    Array,
    BinOp,
    Call,
    Computation,
    Const,
    Expr,
    Loop,
    Neg,
    Program,
    Read,
    acc,
    aff,
    as_expr,
    emax,
    emin,
    expr_ops,
    fingerprint,
    program_fingerprint,
)
from .passes import (  # noqa: F401
    FixpointPass,
    FunctionPass,
    Pass,
    PassContext,
    PassPipeline,
    PassRecord,
)
from .normalize import (  # noqa: F401
    maximal_fission,
    normalization_pipeline,
    normalize,
    stride_minimization,
)
from .fusion import FusionPass, fuse_program, optimization_pipeline  # noqa: F401
from .rewrite import (  # noqa: F401
    CSEPass,
    ExpandFactorPass,
    LICMPass,
    program_flops,
    rewrite_passes,
)
from .codegen import Schedule, compile_torch, execute_numpy, run_torch  # noqa: F401
from .tiling import TilePlan, TilingError, plan_nest_tiling  # noqa: F401
from .cache import CacheStats, CompilationCache, fingerprint_obj  # noqa: F401
from .database import DatabaseCorruption, TuningDatabase  # noqa: F401
from .recipes import Recipe  # noqa: F401
from .scheduler import Daisy, random_inputs  # noqa: F401

"""The port's package boundary: repro_torch loads neither jax nor repro, and
asks for the card unless told to run on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in (SRC / "repro_torch").rglob("*.py")
)


def test_every_module_is_listed():
    assert "repro_torch.core.codegen" in MODULES
    assert "repro_torch.kernels.nest_kernel" in MODULES
    for m in ("repro_torch.configs", "repro_torch.configs.h2o_danube_3_4b",
              "repro_torch.kernels.ref", "repro_torch.kernels.rmsnorm",
              "repro_torch.kernels.flash_attention", "repro_torch.kernels.moe_gmm",
              "repro_torch.models.layers",
              "repro_torch.models.model", "repro_torch.models.convert",
              "repro_torch.models.plain", "repro_torch.serve", "repro_torch.serve.engine",
              "repro_torch.core.search", "repro_torch.fault", "repro_torch.autotune",
              "repro_torch.tools.tune", "repro_torch.tools.explain",
              "repro_torch.models.lowering", "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.compression", "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.train", "repro_torch.train.checkpoint",
              "repro_torch.train.train_loop", "repro_torch.train.fault",
              "repro_torch.launch", "repro_torch.launch.train",
              "repro_torch.core.partition", "repro_torch.launch.mesh",
              "repro_torch.launch.sharding",
              "repro_torch.launch.analytic", "repro_torch.launch.roofline",
              "repro_torch.tools.check_links"):
        assert m in MODULES, m
    assert len(MODULES) >= 50


def test_import_hygiene_subprocess():
    """Import every repro_torch module in a fresh interpreter; no jax* and no
    repro / repro.* module may be loaded."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_import_lines_name_jax_or_repro():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = list((SRC / "repro_torch").rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    hits = [f"{f}:{i + 1}" for f in files
            for i, line in enumerate(f.read_text().splitlines()) if pat.match(line)]
    assert hits == []


def test_daisy_defaults_to_the_card_and_never_falls_back(monkeypatch):
    from repro_torch.core import Daisy, Schedule, compile_torch
    from repro_torch.polybench import BENCHMARKS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Daisy()
    with pytest.raises(RuntimeError, match="cuda"):
        Daisy(backend="torch")
    with pytest.raises(RuntimeError, match="cuda"):
        compile_torch(BENCHMARKS["gemm"].make("a", "mini"), Schedule())
    assert Daisy(device="cpu").device.type == "cpu"


def test_backend_names():
    from repro_torch.core import Daisy, Recipe

    with pytest.raises(ValueError):
        Daisy(backend="xla", device="cpu")
    d = Daisy(backend="torch", device="cpu")
    assert d._backend_recipe(Recipe(kind="pallas_nest", tile=(8, 128))).kind == "vectorize"
    assert d._backend_recipe(Recipe(kind="pallas_reduce")).kind == "vectorize"
    assert d._backend_recipe(Recipe(kind="pallas_gemm")).kind == "einsum"
    assert d._backend_recipe(Recipe(kind="einsum")).kind == "einsum"
    k = Daisy(backend="cuda", device="cpu")
    assert k._backend_recipe(Recipe(kind="pallas_gemm")).kind == "pallas_gemm"


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    from repro_torch.kernels import gemm as kg

    x = torch.ones(3, 4)
    with pytest.raises(ValueError):
        kg.gemm(x, torch.ones(5, 2))
    with pytest.raises(TypeError):
        kg.gemm(x.double(), torch.ones(4, 2).double())
    before = kg.PLAIN["gemm"], kg.LAUNCHES["gemm"]
    out = kg.gemm(x, torch.ones(4, 2))
    assert torch.equal(out, torch.full((3, 2), 4.0))
    assert (kg.PLAIN["gemm"], kg.LAUNCHES["gemm"]) == (before[0] + 1, before[1])

"""Building the port's kernels at first use, inside the checkout.

* CUDA C++ sources under ``repro_torch/csrc`` are compiled by ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface and loaded with
  ``ctypes`` (no PyTorch headers, so a build takes seconds).
* Generated Triton sources are written as modules and imported, since
  ``@triton.jit`` reads a function's source from its file.

Everything lands in ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), keyed by a hash of the source, so a changed source is
rebuilt and an unchanged one is reused.  Triton's own cache goes there too.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import ModuleType

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (build seconds, nvcc's report); empty when the library was reused
BUILD_LOG: dict[str, tuple[float, str]] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_MODULES: dict[str, ModuleType] = {}


def _digest(data: bytes, n: int = 16) -> str:
    return hashlib.sha256(data).hexdigest()[:n]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME)")
    return str(path)


def cuda_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC_DIR / f"{name}.cu"
    so = BUILD_DIR / f"lib{name}-{_digest(src.read_bytes())}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def import_triton():
    """Import triton with its cache kept inside the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton-cache"))
    import triton

    return triton


def generated_module(source: str, stem: str) -> ModuleType:
    """Write ``source`` as ``<stem>_<hash>.py`` in the build directory (once)
    and import it; modules are cached per source text."""
    key = f"{stem}_{_digest(source.encode())}"
    if key in _MODULES:
        return _MODULES[key]
    path = BUILD_DIR / f"{key}.py"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(f"repro_torch_generated.{key}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[key] = mod
    return mod

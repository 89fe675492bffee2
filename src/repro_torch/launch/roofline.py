"""Roofline analysis of dry-run records on the NVIDIA H100.

Port of ``repro/launch/roofline.py``.  Per (arch, shape, mesh) cell, with
per-card numbers:

  compute term    = FLOPs_per_card / peak_FLOPs              [s]
  memory term     = HBM_bytes_per_card / HBM_bw              [s]
  collective term = collective_bytes_per_card / link_bw      [s]

The hardware is an argument (:class:`Hardware`), the H100 by default:
989 TFLOP/s dense bf16, 3.35 TB/s HBM3 and NVLink 4 at 450 GB/s a direction
a card (NVIDIA H100 Tensor Core GPU datasheet, SXM5 part).  The dominant
term is the bottleneck the perf loop iterates on.

MODEL_FLOPS uses the 6·N·D (train) / 2·N·D (inference) convention with
N_active for MoE; the ratio MODEL_FLOPS / (FLOPs × cards) measures how much
compiled compute is "useful" (catches remat/redundant compute).  The input
records are dry-run cells (``arch``, ``shape``, ``mesh``, ``kind``,
``status``, ``n_devices`` and, for ``analytic=False``, ``hlo_flops``,
``hlo_bytes``, ``collective_total``, ``collective_bytes``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from torch.overrides import TorchFunctionMode


@dataclass(frozen=True)
class Hardware:
    """A card's peaks: dense bf16 FLOP/s, HBM bytes/s, link bytes/s."""

    peak_flops: float
    hbm_bw: float
    link_bw: float


H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


class _OnMeta(TorchFunctionMode):
    """Every factory call lands on the meta device, whatever device it names."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _leaves(tree, path: tuple = (), stacked: int = 0):
    """(path, leaf, stacked) per tensor; ``stacked`` is 1 inside a per-layer
    list, which the reference holds as one array with a leading layer axis."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,), stacked)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,), 1)
    else:
        yield path, tree, stacked


def param_counts(arch: str) -> tuple[int, int]:
    """(total, active) parameter counts, the model built on the meta device
    (no allocation) and counted as the reference counts its stacked tree."""
    import torch

    from ..configs import get_config
    from ..models import model as M

    cfg = get_config(arch)
    with _OnMeta():
        params = M.init_params(cfg, torch.Generator())
    total = expert = 0
    for path, leaf, stacked in _leaves(params):
        n = leaf.numel()
        total += n
        if "ffn" in "/".join(map(str, path)) and leaf.dim() + stacked >= 3 and cfg.is_moe:
            expert += n
    active = total
    if cfg.is_moe and cfg.n_experts:
        active = total - expert * (cfg.n_experts - cfg.top_k) // cfg.n_experts
    return total, active


@dataclass
class Cell:
    arch: str
    shape: str
    mesh: str
    kind: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    raw: dict | None = None

    @property
    def step_time(self) -> float:
        """No-overlap upper bound on the step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute term / dominant term: 1.0 = compute-bound at peak."""
        t = self.step_time
        return self.compute_s / t if t else 0.0


def analyse_cell(rec: dict, pcounts: dict[str, tuple[int, int]],
                 analytic: bool = True, hw: Hardware = H100) -> Cell:
    """Roofline terms for one dry-run cell on ``hw``.

    ``analytic=True`` (default) uses the per-arch cost model
    (launch/analytic.py), since compiled cost counts see a scanned layer
    body once; the record's own counts stay in ``raw`` as the cross-check.
    """
    c = Cell(rec["arch"], rec["shape"], rec["mesh"], rec.get("kind", ""),
             rec["status"], raw=rec)
    if rec["status"] != "ok":
        return c
    from ..configs import SHAPES, get_config

    shp = SHAPES[rec["shape"]]
    chips = rec.get("n_devices", 256)
    if analytic:
        from .analytic import MeshInfo, analytic_cost

        tp = 16
        mi = MeshInfo(chips=chips, dp=chips // tp, tp=tp)
        cost = analytic_cost(get_config(rec["arch"]), shp, mi)
        c.compute_s = cost.flops / hw.peak_flops
        c.memory_s = cost.hbm_bytes / hw.hbm_bw
        c.collective_s = cost.coll_bytes / hw.link_bw
    else:
        c.compute_s = rec["hlo_flops"] / hw.peak_flops
        c.memory_s = rec["hlo_bytes"] / hw.hbm_bw
        c.collective_s = rec["collective_total"] / hw.link_bw
    terms = {"compute": c.compute_s, "memory": c.memory_s,
             "collective": c.collective_s}
    c.dominant = max(terms, key=terms.get)

    total, active = pcounts[rec["arch"]]
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    factor = 6 if shp.kind == "train" else 2
    c.model_flops = factor * active * tokens
    hlo_global = c.compute_s * hw.peak_flops * chips
    c.useful_ratio = min(1.0, c.model_flops / hlo_global) if hlo_global else 0.0
    return c


def load_cells(outdir: str | Path, hw: Hardware = H100) -> list[Cell]:
    recs = [json.loads(p.read_text()) for p in sorted(Path(outdir).glob("*.json"))]
    archs = {r["arch"] for r in recs}
    pcounts = {a: param_counts(a) for a in sorted(archs)}
    return [analyse_cell(r, pcounts, hw=hw) for r in recs]


def advice(c: Cell) -> str:
    """One sentence: what would move the dominant term down."""
    if c.status != "ok":
        return ""
    if c.dominant == "compute":
        if c.useful_ratio < 0.5:
            return ("compute-bound with low useful ratio: cut remat recompute "
                    "or redundant einsums (gradient remat policy / fused kernels)")
        return "compute-bound near useful peak: only larger per-card batch helps"
    if c.dominant == "memory":
        return ("memory-bound: fuse elementwise chains / keep activations bf16 "
                "/ widen per-card tile reuse (shared-memory K reuse)")
    top = max(c.raw["collective_bytes"], key=c.raw["collective_bytes"].get)
    return (f"collective-bound (mostly {top}): reshard to cut {top} volume, "
            "overlap with compute, or compress the payload (bf16/int8 grads)")


def markdown_table(cells: list[Cell], mesh: str = "16x16") -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful | bottleneck fix |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.mesh != mesh:
            continue
        if c.status == "skipped":
            rows.append(f"| {c.arch} | {c.shape} | — | — | — | skipped | — | "
                        f"{c.raw.get('reason', '')[:60]} |")
            continue
        rows.append(
            f"| {c.arch} | {c.shape} | {c.compute_s:.3e} | {c.memory_s:.3e} | "
            f"{c.collective_s:.3e} | **{c.dominant}** | {c.useful_ratio:.2f} | "
            f"{advice(c)[:80]} |"
        )
    return "\n".join(rows)

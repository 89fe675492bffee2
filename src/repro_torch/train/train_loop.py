"""The training loop (port of ``repro/train/train_loop.py``): the step,
gradient accumulation, checkpoints, fault tolerance.

``make_train_step`` builds the step (loss -> gradients -> AdamW).
``Trainer`` owns the loop: data prefetch, periodic atomic checkpoints,
heartbeat, straggler monitor, and ``run_resilient``, which survives
injected failures by restoring the last checkpoint (deterministic data makes
the recovery bit-exact).

From JAX to torch: ``jax.value_and_grad`` is ``torch.autograd.grad`` of the
loss with respect to every parameter leaf; the ``lax.scan`` over microbatches
is a loop whose gradients are summed in fp32 and divided, as the reference's
scan carries them; ``jit`` and donation have no counterpart (AdamW updates
in place).  On the card the model's K4, K5 and K6 launch their kernels
forward and backward (``kernels.ops``; K5-bwd and K6-bwd take bf16 only); on
the CPU autograd differentiates their plain versions.  Checkpoints keep the
reference's layout (``hybrid`` and ``ssm`` layers as ``periods``).

Sharded training (``Trainer(mesh=)``, the counterpart of the reference's
pjit placement): each rank holds its shards of the parameters and AdamW
moments (``launch.sharding.param_specs``); the model runs the Megatron
collectives under autograd (``launch.sharding``: *f* and *g*, the
row-parallel slice, the vocabulary-parallel embedding and loss, EP's
combine); ``make_grads`` gives each data-parallel rank its rows of every
microbatch and sums the gradients over the data-parallel axes in one fp32
all-reduce of a flat buffer; the norm that clips and skips is the whole
model's (``optim.adamw.global_norm``).  A checkpoint is the gathered full
tree, written by rank 0 in the reference's layout; a restore re-cuts it
onto the trainer's own mesh, whatever mesh saved it.  The ``hybrid``,
``ssm`` and ``audio`` families under a mesh of more than one rank are
ROADMAP queue 1, item 6, step 3a-iii; a ``grad_codec`` over a ``pod_axis``
(the compressed cross-pod all-reduce) raises ``NotImplementedError``: step
3b.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..core.cache import fingerprint_obj
from ..core.codegen import check_device
from ..core.database import TuningDatabase
from ..data.pipeline import DataConfig, LMDataPipeline
from ..fault import Heartbeat, RestartPolicy, StragglerMonitor
from ..launch import sharding as SH
from ..launch.mesh import dp_axes, set_mesh
from ..models import layers as L
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_unflatten
from .checkpoint import CheckpointManager, from_periods, to_periods


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, group=None,
                  offset: int = 0) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32: the max-shifted log-sum-exp of
    each position's logits (``torch.logsumexp``) minus its label's logit.

    With ``group``, the logits are this rank's vocabulary columns, from
    ``offset``, and the loss is vocab-parallel as the reference's is
    (``repro/train/train_loop.py:32-47``): the maximum over ``group`` (no
    gradient), then the sum of the shifted exponentials and the label's
    logit, each summed over ``group``; the ``(B, S, V)`` logits are never
    gathered."""
    lf = logits.float()
    if group is None:
        lse = torch.logsumexp(lf, dim=-1)
        ll = lf.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
        return torch.mean(lse - ll)
    v = lf.shape[-1]
    m = SH.all_reduce_max(lf.detach().amax(dim=-1), group)
    lse = torch.log(SH.all_reduce_sum(torch.exp(lf - m[..., None]).sum(dim=-1), group)) + m
    local = labels.long() - offset
    mine = (local >= 0) & (local < v)
    ll = lf.gather(-1, local.clamp(0, v - 1).unsqueeze(-1)).squeeze(-1)
    ll = SH.all_reduce_sum(torch.where(mine, ll, torch.zeros_like(ll)), group)
    return torch.mean(lse - ll)


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """The loss of ``forward``'s logits; vocab-parallel where they are
    vocab-local (under the current mesh)."""
    logits = M.forward(cfg, params, batch)
    if L._split(logits.shape[-1], cfg.vocab, "logits"):
        _, r, group = L._tp()
        return cross_entropy(logits, batch["labels"], group, r * logits.shape[-1])
    return cross_entropy(logits, batch["labels"])


def make_grads(cfg: ModelConfig, accum_steps: int = 1, mesh=None):
    """Returns grads(params, batch) -> (loss, gradients in ``tree_leaves``
    order): the mean loss of ``batch`` and its gradient.

    ``accum_steps`` > 1 runs the batch as that many microbatches one after
    another and sums their gradients in fp32 (then divides), as the
    reference's scan carries them.  Under a mesh with data-parallel axes of
    n > 1 ranks, ``batch`` is the whole batch on every rank: microbatch i is
    rows ``i*mb .. (i+1)*mb`` and this rank takes its ``mb / n`` of them in
    rank order.  The fp32 sum of its microbatches' gradients (and its loss)
    lie in one flat buffer in ``tree_leaves`` order, which is summed over
    the data-parallel axes in one fp32 all-reduce and divided by n: the
    same gradient on every replica, run to run."""
    dp = dp_axes(mesh) if mesh is not None else ()
    dpn, d = SH.shard_index(mesh, dp) if dp else (1, 0)
    group = mesh.get_group(dp) if dpn > 1 else None

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        with set_mesh(mesh):
            loss = loss_fn(cfg, params, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)

    def grads(params, batch):
        b = batch["tokens"].shape[0]
        if b % (accum_steps * dpn):
            raise ValueError(f"batch of {b} does not split into {accum_steps} microbatches over "
                             f"{dpn} data-parallel ranks")
        if accum_steps == 1 and dpn == 1:
            return grads_of(params, batch)
        mb = b // accum_steps
        rows = mb // dpn
        acc, loss = None, 0.0
        for i in range(accum_steps):
            lo = i * mb + d * rows
            micro = {k: v[lo:lo + rows] for k, v in batch.items()}
            loss_i, g_i = grads_of(params, micro)
            if acc is None:  # the bf16 gradients' fp32 values, in one buffer, the loss last
                flat = torch.empty(sum(g.numel() for g in g_i) + 1, dtype=torch.float32,
                                   device=g_i[0].device)
                acc = [a.view(g.shape) for a, g in
                       zip(torch.split(flat[:-1], [g.numel() for g in g_i]), g_i)]
                for a, g in zip(acc, g_i):
                    a.copy_(g)
            else:
                for a, g in zip(acc, g_i):
                    a.add_(g)
            del g_i
            loss = loss + loss_i
        if accum_steps > 1:
            for a in acc:
                a.div_(accum_steps)
            loss = loss / accum_steps
        if dpn > 1:
            flat[-1] = loss
            SH.reduce_gradients_(flat, group).div_(dpn)
            loss = flat[-1].clone()
        return loss, acc

    return grads


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    accum_steps: int = 1,
    grad_codec: str = "none",
    pod_axis: str | None = None,
    mesh=None,
    specs=None,
):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum_steps`` > 1 splits the batch into microbatches run one after
    another: activation memory drops by the factor, FLOPs unchanged.  Under
    ``mesh`` the parameters and moments are this rank's shards cut by
    ``specs``, the batch is the whole batch on every rank (``make_grads``)
    and the norm that clips is the whole model's.  Compressing a cross-pod
    all-reduce (``grad_codec`` over ``pod_axis``) is not ported.
    """
    if pod_axis is not None:
        raise NotImplementedError("make_train_step: grad_codec over a pod_axis (the compressed "
                                  "cross-pod all-reduce) is not ported yet (see ROADMAP queue 1, "
                                  "item 6, step 3b)")
    grads_of = make_grads(cfg, accum_steps, mesh)

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        grads = tree_unflatten(params, list(grads))
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                                  mesh=mesh, specs=specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


@dataclass
class TrainerConfig:
    ckpt_dir: str = field(default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                                                "repro_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    heartbeat: str | None = None
    accum_steps: int = 1


def _trainable(params):
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        data_cfg: DataConfig,
        tcfg: TrainerConfig,
        seed: int = 0,
        tuning_db: TuningDatabase | None = None,
        mesh=None,
        telemetry=None,
        device: str | torch.device | None = None,
    ):
        """Parameters from ``models.model.init_params`` seeded with ``seed`` on
        ``device`` (the card unless the caller asks for the CPU; under a mesh
        the mesh's device, and another ``device`` raises).
        ``telemetry`` (a ``repro_torch.autotune.NestTelemetry``, e.g. a
        ``SearchSupervisor``'s) receives per-step wall times; without one the
        observations hit a disabled sink.

        ``mesh`` (a ``launch.mesh`` mesh over ``data``/``pod``/``model``
        axes; every rank of the world constructs its ``Trainer`` alike):
        every rank builds the full tree from ``seed`` on ``mesh.device`` and
        cuts it with ``launch.sharding.param_specs`` (the reference's
        semantics: every rank holds the same model), then creates the AdamW
        moments, shard-shaped.  Each step takes the whole batch on every
        rank (``make_grads``).  The ``hybrid``, ``ssm`` and ``audio``
        families raise under a mesh of more than one rank (ROADMAP queue 1,
        item 6, step 3a-iii)."""
        from ..models.lowering import deployment_context

        self.mesh = mesh
        self._world = mesh is not None and math.prod(mesh.shape.values()) > 1
        if self._world and cfg.family in ("hybrid", "ssm", "audio"):
            raise NotImplementedError(
                f"Trainer: the {cfg.family} family under a mesh of more than one rank is not "
                "ported yet (ROADMAP queue 1, item 6, step 3a-iii)")
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        dev = None if device is None else torch.device(device)
        if mesh is not None and dev is not None and (
                dev.type != mesh.device.type or dev.index not in (None, mesh.device.index)):
            raise ValueError(f"Trainer: device {device} is not the mesh's {mesh.device}")
        self.device = mesh.device if mesh is not None else check_device(device or "cuda")
        self.seed = seed
        # Shared deployment boilerplate (warm pretuned tuning DB, content-keyed
        # build cache, telemetry, the mesh's cut) — the helper ServingEngine's
        # constructor uses.
        self._ctx = deployment_context(cfg, self._full_params(), mesh=mesh,
                                       tuning_db=tuning_db, telemetry=telemetry)
        self.tuning_db = self._ctx.tuning_db
        self.telemetry = self._ctx.telemetry
        self._telemetry_key = f"train.step:{fingerprint_obj(cfg)[:12]}"
        self.data = LMDataPipeline(data_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.monitor = StragglerMonitor()
        self.hb = Heartbeat(tcfg.heartbeat) if tcfg.heartbeat else None
        self.params = _trainable(self._ctx.params)
        self.opt_state = adamw_init(self.params)
        # Keyed by config content and the mesh: a Trainer re-created with
        # equal configs (checkpoint-resume, restarts) reuses the built step.
        self.step_fn = self._ctx.jitted(
            "train.step",
            lambda: make_train_step(cfg, opt_cfg, accum_steps=tcfg.accum_steps, mesh=mesh,
                                    specs=self._ctx.specs),
            fingerprint_obj(opt_cfg), tcfg.accum_steps, mesh,
        )
        self.step = 0
        self.history: list[dict] = []

    def _full_params(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return M.init_params(self.cfg, gen)

    def _init_params(self):
        """Fresh parameters from the seed, cut to this rank's shards."""
        return _trainable(self._ctx.place(self._full_params()))

    def explain_kernels(self) -> str:
        """Pass-pipeline + contraction-plan report at this trainer's data
        shape (content-cached: restarted trainers share one pipeline run)."""
        from ..models.lowering import kernel_report

        dcfg = self.data.cfg
        return self._ctx.jitted(
            "train.kernel_report",
            lambda: kernel_report(
                self.cfg, seq=dcfg.seq_len, batch=dcfg.global_batch,
                db=self.tuning_db,
            ),
            dcfg.seq_len, dcfg.global_batch,
            self.tuning_db.uid, self.tuning_db.generation,
        )

    # -- checkpoint plumbing --------------------------------------------------
    def _tree(self):
        """What a checkpoint holds, in the reference's layout: ``hybrid`` and
        ``ssm`` layers as ``periods``.  Under a mesh of more than one rank
        the full tree, gathered into the first rank's host memory (None on
        the others; every rank must call it)."""
        tree = {"params": self.params, "opt": self.opt_state}
        if self._world:
            specs, mesh = self._ctx.specs, self.mesh
            parts = [SH.gather_to_root(t, specs, mesh)
                     for t in (self.params, self.opt_state["m"], self.opt_state["v"])]
            if mesh.rank != mesh.ranks[0]:
                return None
            tree = {"params": parts[0],
                    "opt": {"m": parts[1], "v": parts[2], "step": self.opt_state["step"]}}
        period = M.layer_period(self.cfg)
        return to_periods(tree, period) if period else tree

    def _template(self):
        """The checkpoint's shapes: this trainer's tree, or under a mesh of
        more than one rank the full tree's shapes (on the host, no data)."""
        if not self._world:
            return self._tree()
        specs = self._ctx.specs

        def full(path, leaf, _):
            spec = SH._lookup(specs, path)
            shape = [n * SH.shard_index(self.mesh, e)[0] for n, e in zip(leaf.shape, spec)]
            return torch.zeros((), dtype=leaf.dtype).expand(shape)

        return {"params": SH._walk(self.params, full),
                "opt": {"m": SH._walk(self.opt_state["m"], full),
                        "v": SH._walk(self.opt_state["v"], full),
                        "step": self.opt_state["step"]}}

    def save(self) -> None:
        """A checkpoint of this step; under a mesh of more than one rank the
        gathered tree, which the first rank writes while the others wait."""
        tree = self._tree()
        if tree is not None:
            self.ckpt.save(self.step, tree, extra={"step": self.step})
        if self._world:
            del tree
            dist.barrier()

    def try_restore(self) -> bool:
        """The latest checkpoint, whatever mesh saved it: under a mesh the
        full tree is read and cut onto this trainer's mesh (parameters and
        moments with the parameters' specs)."""
        if self.ckpt.latest_step() is None:
            return False
        try:
            step, tree, _ = self.ckpt.restore(self._template())
        except (KeyError, ValueError):
            return False  # incompatible checkpoint (e.g. config changed)
        tree = from_periods(tree)
        if self.mesh is not None:
            for part in (tree["params"], tree["opt"]["m"], tree["opt"]["v"]):
                self._ctx.place(part)
        self.params = _trainable(tree["params"])
        self.opt_state = tree["opt"]
        self.step = step
        return True

    def _batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    # -- loops ----------------------------------------------------------------
    def run(self, n_steps: int, fail_at: int | None = None) -> list[dict]:
        """Train n_steps from the current position. ``fail_at`` injects a
        crash (tests the restart path)."""
        if self.hb:
            self.hb.start()
        self.data.start(self.step)
        try:
            target = self.step + n_steps
            while self.step < target:
                step_id, batch = self.data.next()
                assert step_id == self.step, (step_id, self.step)
                if fail_at is not None and self.step == fail_at:
                    raise RuntimeError(f"injected failure at step {self.step}")
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, self._batch(batch)
                )
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                self.monitor.observe(self.step, dt)
                self.telemetry.observe(self._telemetry_key, dt)
                self.step += 1
                rec = {"step": self.step, "loss": loss, "dt": dt,
                       "lr": float(metrics["lr"]), "skipped": bool(metrics["skipped"])}
                self.history.append(rec)
                if self.step % self.tcfg.ckpt_every == 0:
                    self.save()
            return self.history
        finally:
            self.data.stop()
            if self.hb:
                self.hb.stop()

    def run_resilient(self, n_steps: int, fail_at: int | None = None,
                      policy: RestartPolicy | None = None) -> list[dict]:
        """run() wrapped in restore-and-retry (the supervisor loop a cluster
        scheduler would drive)."""
        policy = policy or RestartPolicy()
        target = self.step + n_steps
        while True:
            try:
                self.run(target - self.step, fail_at=fail_at)
                return self.history
            except RuntimeError as e:
                if not policy.should_restart(e):
                    raise
                fail_at = None  # the injected failure happens once
                restored = self.try_restore()
                if not restored:  # no checkpoint yet: restart from scratch
                    self.params = self._init_params()
                    self.opt_state = adamw_init(self.params)
                    self.step = 0

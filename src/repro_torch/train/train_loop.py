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

``mesh`` and a ``grad_codec`` over a ``pod_axis`` raise
``NotImplementedError``: the port trains on one device.  Sharded training
(the Megatron collectives under autograd, the DP gradient all-reduce,
restores that re-place the parameters and moments) is ROADMAP queue 1, item
6, step 3a-ii; the compressed cross-pod all-reduce is step 3b.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..configs.base import ModelConfig
from ..core.cache import fingerprint_obj
from ..core.codegen import check_device
from ..core.database import TuningDatabase
from ..data.pipeline import DataConfig, LMDataPipeline
from ..fault import Heartbeat, RestartPolicy, StragglerMonitor
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_unflatten
from .checkpoint import CheckpointManager, from_periods, to_periods


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32: the max-shifted log-sum-exp of
    each position's logits (``torch.logsumexp``) minus its label's logit."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - ll)


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    logits = M.forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"])


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    accum_steps: int = 1,
    grad_codec: str = "none",
    pod_axis: str | None = None,
):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum_steps`` > 1 splits the batch into microbatches run one after
    another: activation memory drops by the factor, FLOPs unchanged.
    Compressing a cross-pod all-reduce (``grad_codec`` over ``pod_axis``)
    needs the model stack's sharding, which is not ported.
    """
    if pod_axis is not None:
        raise NotImplementedError("make_train_step: grad_codec over a pod_axis needs sharded "
                                  "training, which is not ported yet (see ROADMAP queue 1, "
                                  "item 6, steps 3a-ii and 3b)")

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(cfg, params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch of {b} does not split into {accum_steps} microbatches")
            mb = b // accum_steps
            grads, loss = None, 0.0
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, g_i = grads_of(params, micro)
                if grads is None:  # zeros + g: the bf16 gradients' fp32 values
                    grads = [g.float() for g in g_i]
                else:
                    for acc, g in zip(grads, g_i):
                        acc.add_(g)
                del g_i
                loss = loss + loss_i
            for acc in grads:
                acc.div_(accum_steps)
            loss = loss / accum_steps
        grads = tree_unflatten(params, list(grads))
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state)
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
        device: str | torch.device = "cuda",
    ):
        """Parameters from ``models.model.init_params`` seeded with ``seed`` on
        ``device`` (the card unless the caller asks for the CPU).
        ``telemetry`` (a ``repro_torch.autotune.NestTelemetry``, e.g. a
        ``SearchSupervisor``'s) receives per-step wall times; without one the
        observations hit a disabled sink.  ``mesh`` raises: the port trains
        on one device (sharded training is ROADMAP queue 1, item 6, step
        3a-ii)."""
        from ..models.lowering import deployment_context

        if mesh is not None:
            raise NotImplementedError("Trainer: mesh is not ported yet (sharded training: see "
                                      "ROADMAP queue 1, item 6, step 3a-ii)")

        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.device = check_device(device)
        self.seed = seed
        self.mesh = mesh
        # Shared deployment boilerplate (warm pretuned tuning DB, content-keyed
        # build cache, telemetry) — the helper ServingEngine's constructor uses.
        self._ctx = deployment_context(cfg, self._init_params(), mesh=mesh,
                                       tuning_db=tuning_db, telemetry=telemetry)
        self.tuning_db = self._ctx.tuning_db
        self.telemetry = self._ctx.telemetry
        self._telemetry_key = f"train.step:{fingerprint_obj(cfg)[:12]}"
        self.data = LMDataPipeline(data_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.monitor = StragglerMonitor()
        self.hb = Heartbeat(tcfg.heartbeat) if tcfg.heartbeat else None
        self.params = self._ctx.params
        self.opt_state = adamw_init(self.params)
        # Keyed by config content: a Trainer re-created with equal configs
        # (checkpoint-resume, restarts) reuses the built step.
        self.step_fn = self._ctx.jitted(
            "train.step",
            lambda: make_train_step(cfg, opt_cfg, accum_steps=tcfg.accum_steps),
            fingerprint_obj(opt_cfg), tcfg.accum_steps,
        )
        self.step = 0
        self.history: list[dict] = []

    def _init_params(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return _trainable(M.init_params(self.cfg, gen))

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
        ``ssm`` layers as ``periods``."""
        tree = {"params": self.params, "opt": self.opt_state}
        period = M.layer_period(self.cfg)
        return to_periods(tree, period) if period else tree

    def save(self) -> None:
        self.ckpt.save(self.step, self._tree(), extra={"step": self.step})

    def try_restore(self) -> bool:
        if self.ckpt.latest_step() is None:
            return False
        try:
            step, tree, _ = self.ckpt.restore(self._tree())
        except (KeyError, ValueError):
            return False  # incompatible checkpoint (e.g. config changed)
        tree = from_periods(tree)
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

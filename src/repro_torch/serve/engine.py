"""Continuous-batching serving engine (port of ``repro/serve/engine.py``).

Ported from the reference's ``ServingEngine`` (``repro/serve/engine.py:208``):

  * ``submit(prompt)`` returns a :class:`RequestHandle` (``.state``,
    ``.tokens``, ``.result()``, ``.cancel()``, optional per-token streaming
    callback); ``step()`` advances the engine one scheduling iteration and
    ``drain()`` runs to completion; ``shutdown()`` closes it; ``run()``
    survives as a deprecated wrapper.
  * one **batched decode** over all ``batch_slots`` at once
    (``models.model.decode_slots``): every slot carries its own cache
    length, so a freshly admitted request coexists with half-finished ones.
  * **bucketed prefill**: prompts are right-padded to power-of-two buckets;
    the padded cache rows are causally masked (the slot's ``len`` is reset
    to the true prompt length) and overwritten as decode proceeds.  The
    ``hybrid`` and ``ssm`` families prefill at the exact length
    (``_bucket_for``): a padded token would enter their recurrent states.
  * **pipelined greedy dispatch**: the argmax is taken on the device and the
    sampled tokens feed the next step directly; their copy to the host is
    started at dispatch and waited for only at harvest, ``pipeline_depth``
    steps behind.  Temperature sampling needs the logits on the host each
    step and harvests synchronously.
  * request-scoped failure: a request whose prefill or harvest raises, or
    whose logits go non-finite, transitions to ``FAILED`` and frees its
    slot; ``submit(..., timeout_s=)`` deadlines, ``handle.cancel()``, and
    eos refill of a finished slot from the queue, as in the reference.
  * ``tuning_db`` (default: the shared ``models.lowering.deployment_database``)
    and ``explain_kernels()``, the pass-pipeline and contraction-plan report
    at the serving shape, cached under the database's uid and generation.
  * ``audio`` (encoder-decoder): each admitted request's encoder memory is
    computed at prefill from zero frame embeddings, as the reference's stub
    frontend does, and kept in its slot.  ``vlm`` is served text-only, as in
    the reference (its patch embeddings reach ``forward`` only).
  * a tuned **logit program** (``logit_program``, e.g.
    ``repro_torch.autotune.logit_pipeline_program``) runs inside every
    decode step: the step's ``(N, V)`` logits enter its ``X`` vocab-major as
    ``(V, N)``, sampling reads its ``Y``.  It is lowered by ``Daisy`` under
    ``program_backend`` (``'cuda'``: its canonical nest on the nest kernel,
    K2) against ``tuning_db``; a database commit (a new generation)
    hot-swaps it at the next ``step()``, and the compiled program is cached
    by the recipes it resolves, so a rollback is a cache hit.
    ``tuner`` attaches a ``repro_torch.autotune.SearchSupervisor``: busy
    steps are timed into its telemetry and it is driven every
    ``check_every`` steps — the online tuning loop.
  * ``compile_resilient``: a tuned program compiled and run once per
    backend (``cuda`` -> ``torch``), degradations recorded on
    ``degradations``; ``fault_plan`` (a seeded ``repro_torch.fault.
    FaultPlan``) poisons exactly the scheduled requests at the sites
    ``serve.prefill`` / ``serve.decode`` / ``serve.logits`` /
    ``serve.step``, as in the reference.

Under a ``mesh`` (``launch.mesh.make_mesh`` over a ``torch.distributed``
world, with ``data``/``model`` and optionally ``pod`` axes) every rank runs
the same requests SPMD, as GSPMD runs the reference's engine: the
parameters are cut to this rank's shards (``launch.sharding``: heads, dense
FFN columns and rows and the vocabulary over ``model``, experts over
``model``), and the batch slots go over the DP axes where they divide them,
else every rank holds every slot.  Every rank runs the same host scheduler.
A prefill runs on the ranks that own its slot and its last logits (whole
vocabulary) are broadcast to every rank, each step's sampled tokens are
gathered to every rank, and the sync path (temperature, logit program)
gathers the whole-vocabulary logits of every slot, so every rank's handles,
queues, random generator and results stay identical.  Request deadlines and
``cancel()`` are decided on rank 0 and broadcast before each step (a
cancellation takes effect at the next step): a decision that differed
between ranks would leave one rank out of a collective the others enter.
``tuner`` with a mesh of more than one rank raises (ROADMAP queue 1, item
6, step 3a-iii), and so do the ``hybrid``, ``ssm`` and ``audio`` families
under a ``model`` axis of more than one rank.  A mesh of one runs the
unsharded path.
torch runs eagerly, so no step function is traced.

The engine runs on the device its parameters are on (the card unless the
caller built them on the CPU)::

    from repro_torch.serve import ServeConfig, ServingEngine

    eng = ServingEngine(cfg, params, ServeConfig(batch_slots=8, max_len=4096))
    h = eng.submit(prompt_tokens, on_token=lambda h, t: print(h.rid, t))
    eng.drain()
    print(h.tokens)
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from concurrent.futures import CancelledError
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..fault import FaultPlan
from ..launch import sharding as SH
from ..launch.mesh import dp_axes, set_mesh
from ..models import model as M
from ..models.lowering import deployment_context, kernel_report


class NonFiniteLogits(RuntimeError):
    """A request's logits went NaN/inf — numeric poison isolated to the one
    request instead of propagating through the batch."""


class RequestState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    TIMED_OUT = "timed_out"
    CANCELLED = "cancelled"


TERMINAL_STATES = frozenset(
    {RequestState.COMPLETED, RequestState.FAILED, RequestState.TIMED_OUT,
     RequestState.CANCELLED}
)


@dataclass
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0
    seed: int = 0
    eos_id: int = -1  # -1: never stops early
    # dispatch-ahead distance for the greedy path: how many batched steps may
    # be in flight before the host blocks on the oldest one's tokens
    pipeline_depth: int = 2
    min_bucket: int = 16  # smallest prefill bucket (powers of two upward)


def prefill_buckets(max_len: int, min_bucket: int = 16) -> tuple[int, ...]:
    """The padded prompt lengths prefill admission rounds up to: powers of
    two from ``min_bucket`` to ``max_len`` (``max_len`` itself always
    included so any prompt the cache can hold has a bucket)."""
    out: list[int] = []
    b = min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


@dataclass(eq=False)
class RequestHandle:
    """A submitted request's live view: ``tokens`` grows as the engine
    harvests decode steps, ``state`` walks QUEUED → RUNNING → one terminal
    state (COMPLETED / FAILED / TIMED_OUT / CANCELLED), and ``result()``
    drives the engine until completion.  An ``on_token`` callback
    (``fn(handle, token)``) streams tokens as they are harvested; ``error``
    holds the captured exception of a FAILED request."""

    rid: int
    prompt: np.ndarray
    tokens: list[int] = field(default_factory=list)
    state: RequestState = RequestState.QUEUED
    error: BaseException | None = None
    deadline: float | None = None  # absolute time.monotonic() cutoff
    on_token: Callable[["RequestHandle", int], None] | None = None
    _engine: "ServingEngine | None" = field(default=None, repr=False)

    @property
    def done(self) -> bool:
        """True once the request reached any terminal state."""
        return self.state in TERMINAL_STATES

    @property
    def failed(self) -> bool:
        return self.state is RequestState.FAILED

    def result(self) -> list[int]:
        """Drive the owning engine until this request completes and return
        the generated tokens.  Raises the captured error for a FAILED
        request, :class:`TimeoutError` for a TIMED_OUT one and
        :class:`CancelledError` after ``cancel()``."""
        while not self.done:
            if self._engine is None or self._engine.step() == 0 and not self.done:
                raise RuntimeError(f"request {self.rid} cannot complete: engine is idle")
        if self.state is RequestState.FAILED:
            raise self.error if self.error is not None else \
                RuntimeError(f"request {self.rid} failed")
        if self.state is RequestState.TIMED_OUT:
            raise TimeoutError(f"request {self.rid} exceeded its deadline after "
                               f"{len(self.tokens)} token(s)")
        if self.state is RequestState.CANCELLED:
            raise CancelledError(f"request {self.rid} was cancelled")
        return self.tokens

    def cancel(self) -> bool:
        """Withdraw the request: True if it transitioned to CANCELLED,
        False if it had already reached a terminal state."""
        if self.done:
            return False
        if self._engine is not None:
            self._engine._request_cancel(self)
        else:
            self.state = RequestState.CANCELLED
        return True

    def _overdue(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def _append(self, tok: int, scfg: ServeConfig) -> None:
        self.tokens.append(tok)
        if self.on_token is not None:
            self.on_token(self, tok)
        if len(self.tokens) >= scfg.max_new_tokens or tok == scfg.eos_id:
            self.state = RequestState.COMPLETED


def _start_copy(t: torch.Tensor):
    """Start copying ``t`` to the host; ``_finish_copy`` waits for it."""
    if t.device.type != "cuda":
        return t, None
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return buf, done


def _finish_copy(copy) -> np.ndarray:
    buf, done = copy
    if done is not None:
        done.synchronize()
    return buf.numpy()


class ServingEngine:
    """Single-device continuous-batching engine.

    Lifecycle::

        eng = ServingEngine(cfg, params, ServeConfig(...))
        h = eng.submit(prompt, timeout_s=5.0)  # -> RequestHandle, queued
        eng.step()                      # admit + one batched decode + harvest
        eng.drain()                     # run to completion, {rid: tokens}
        h.result()                      # or drive until this handle is done
        h.cancel()                      # withdraw a queued/running request

    ``drain()`` (and ``shutdown()``) closes the engine: later ``submit``
    calls raise.
    """

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, tuning_db=None,
                 mesh=None, fault_plan: FaultPlan | None = None, logit_program=None,
                 logit_inputs=None, tuner=None, program_backend: str = "cuda"):
        """``fault_plan`` arms deterministic fault injection.  ``logit_program``
        (a canonical loop-nest ``Program`` with ``X`` and ``Y`` of shape
        ``(vocab, batch_slots)``) runs in every decode step, lowered under
        ``program_backend`` against ``tuning_db``; ``logit_inputs`` supplies
        its other input arrays (missing ones are zero-filled).  ``tuner`` (a
        ``SearchSupervisor`` over the same database) registers the program,
        receives per-step telemetry and is driven every
        ``tuner.check_every`` steps.  ``mesh``: serve SPMD over a
        ``launch.mesh`` mesh (the module's docstring); the full ``params``
        are cut in place to this rank's shards."""
        self._world = mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1
        if tuner is not None and self._world:
            raise NotImplementedError(
                "ServingEngine: tuner under a mesh of more than one rank is not ported yet "
                "(the tuner deciding on rank 0: ROADMAP queue 1, item 6, step 3a-iii)")
        self.cfg, self.scfg, self.mesh = cfg, scfg, mesh
        if tuner is not None:
            if tuning_db is None:
                tuning_db = tuner.db
            elif tuning_db is not tuner.db:
                raise ValueError(
                    "tuner.db and tuning_db are different databases; the "
                    "supervisor must commit swaps into the database the "
                    "engine resolves recipes from")
        self._ctx = deployment_context(
            cfg, params, mesh=mesh, tuning_db=tuning_db,
            telemetry=tuner.telemetry if tuner is not None else None)
        self.params = self._ctx.params
        self.tuning_db = self._ctx.tuning_db
        self.telemetry = self._ctx.telemetry
        self.device = self.params["embed"].device
        self.fault_plan = fault_plan
        self.tuner = tuner
        self._step_count = 0
        # (program name, from backend, to backend) of every compile that
        # degraded down the backend chain (compile_resilient, the tuner's
        # validations)
        self.degradations: list[tuple[str, str, str]] = []
        self.logit_program = logit_program
        if logit_program is not None:
            from ..core import Daisy, program_fingerprint

            self.program_backend = program_backend
            self._daisy = Daisy(db=self.tuning_db, backend=program_backend, device=self.device)
            self._prog_key = program_fingerprint(logit_program)
            self._prog_aux = self._build_aux(logit_inputs or {})
            self._telemetry_key = self._prog_key
            if tuner is not None:
                tuner.register(logit_program)
            self._prog_gen: int | None = None
            self._resolve_step_fns()
        else:
            from ..core.cache import fingerprint_obj

            self._telemetry_key = f"serve.step:{fingerprint_obj(cfg)[:12]}"
            # looked up at call time, so a wrapped model function is seen;
            # both give every slot's output on every rank
            self._dispatch_greedy = lambda p, s, t: self._all_slots(
                *M.decode_slots_greedy(cfg, p, s, t))
            self._dispatch_logits = lambda p, s, t: self._all_slots(
                *self._full_logits(*M.decode_slots(cfg, p, s, t)))
        n = scfg.batch_slots
        self._buckets = prefill_buckets(scfg.max_len, scfg.min_bucket)
        # this rank's slots [base, base + n_local): all of them unless the
        # DP axes divide the slots
        self._n_local, self._base = SH.slot_layout(n, mesh)
        self._src = self._source_ranks()
        with set_mesh(mesh):
            self._states = M.init_slot_states(cfg, n, scfg.max_len, device=self.device)
        self._tokens = torch.zeros((self._n_local,), dtype=torch.int32, device=self.device)
        self._slots: list[RequestHandle | None] = [None] * n
        self._queue: deque[RequestHandle] = deque()
        # in-flight dispatched steps: (host copy of tokens or logits, {slot: handle})
        self._pending: deque[tuple[Any, dict[int, RequestHandle]]] = deque()
        self.results: dict[int, list[int]] = {}
        self.failed: dict[int, RequestHandle] = {}
        self._inflight: dict[int, RequestHandle] = {}
        self._closed = False
        self._next_rid = 0
        self.rng = np.random.default_rng(scfg.seed)
        # mesh of more than one rank: rank 0's decisions for the current step
        self._overdue_rids: set[int] = set()
        self._cancels: list[int] = []

    # -- public API ------------------------------------------------------------
    def submit(self, prompt, _legacy_prompt=None, *, rid: int | None = None,
               on_token: Callable[[RequestHandle, int], None] | None = None,
               timeout_s: float | None = None) -> RequestHandle:
        """Queue a prompt; returns its :class:`RequestHandle`.

        ``timeout_s`` arms a per-request deadline (measured from submission).
        Duplicate in-flight ``rid``s and submissions after ``drain()`` /
        ``shutdown()`` are rejected.  The legacy positional form
        ``submit(rid, prompt)`` still works but is deprecated.
        """
        if _legacy_prompt is not None:
            warnings.warn(
                "ServingEngine.submit(rid, prompt) is deprecated; use "
                "submit(prompt, rid=...) -> RequestHandle",
                DeprecationWarning, stacklevel=2)
            rid, prompt = int(prompt), _legacy_prompt
        if self._closed:
            raise RuntimeError(
                "ServingEngine is shut down (drain()/shutdown() was called); "
                "create a new engine to serve more requests")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {prompt.shape}")
        if prompt.size > self._buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest prefill "
                f"bucket {self._buckets[-1]} (max_len={self.scfg.max_len})")
        if prompt.size + self.scfg.max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"prompt length {prompt.size} + max_new_tokens "
                f"{self.scfg.max_new_tokens} exceeds max_len "
                f"{self.scfg.max_len} (the decode cache would overflow)")
        if rid is None:
            rid = self._next_rid
        elif rid in self._inflight:
            raise ValueError(
                f"rid {rid} is already in flight (state "
                f"{self._inflight[rid].state.value}); pass a fresh rid or omit it")
        self._next_rid = max(self._next_rid, rid) + 1
        deadline = time.monotonic() + timeout_s if timeout_s is not None else None
        h = RequestHandle(rid=rid, prompt=prompt, on_token=on_token,
                          deadline=deadline, _engine=self)
        self._inflight[rid] = h
        self._queue.append(h)
        return h

    def step(self) -> int:
        """One scheduling iteration: admit queued requests into free slots,
        dispatch one batched decode over the occupied slots, harvest the
        steps that are due.  Returns the number of occupied slots at dispatch
        (0 = idle: queue empty, nothing in flight).

        Instrumented for online tuning: busy steps are timed on the host
        clock into the telemetry sink (a no-op predicate when disabled), and
        an attached tuner is driven every ``tuner.check_every`` steps —
        launches searches on the hottest nests and applies or rolls back
        swaps at the poll point."""
        if self.logit_program is not None:
            self._resolve_step_fns()  # picks up database commits (hot swap)
        t0 = time.perf_counter()
        with set_mesh(self.mesh):
            self._sync_decisions()
            n = self._step_impl()
        if n:
            self.telemetry.observe(self._telemetry_key, time.perf_counter() - t0)
        self._step_count += 1
        if self.tuner is not None and self._step_count % self.tuner.check_every == 0:
            self.tuner.maybe_launch()
            self.tuner.poll(engine=self)
        return n

    def _step_impl(self) -> int:
        scfg = self.scfg
        sync = scfg.temperature > 0.0
        depth = 0 if sync else max(0, scfg.pipeline_depth)
        self._expire_queued()
        self._admit()
        live = {i: h for i, h in enumerate(self._slots) if h is not None}
        if not live:
            while self._pending:
                self._harvest_one()
            return 0
        try:
            if self.fault_plan is not None:
                self.fault_plan.maybe_raise("serve.step")
            if sync:
                logits, self._states = self._dispatch_logits(
                    self.params, self._states, self._tokens)
                self._pending.append((_start_copy(logits.float()), live))
            else:
                # pipelined: the sampled tokens stay on the device and feed
                # the next dispatch; the host reads them `depth` steps later
                next_tok, self._states = self._dispatch_greedy(
                    self.params, self._states, self._tokens)
                self._tokens = self._mine(next_tok)
                self._pending.append((_start_copy(next_tok), live))
        except Exception as e:  # noqa: BLE001 — batch-level dispatch failure
            # the whole step is lost: fail the requests that occupied slots,
            # recycle them, and keep the engine serviceable for the queue
            for i, h in live.items():
                self._fail(h, e, slot=i)
            return self._step_impl() if self._queue or self._pending else 0
        while len(self._pending) > depth:
            self._harvest_one()
        return len(live)

    def drain(self) -> dict[int, list[int]]:
        """Run until the queue and every slot are empty, then shut the
        engine down; returns ``rid -> generated tokens`` for every request
        that COMPLETED."""
        while self._queue or self._pending or any(h is not None for h in self._slots):
            self.step()
        self._closed = True
        return self.results

    def shutdown(self) -> None:
        """Close the engine without draining: queued and running requests
        transition to CANCELLED (running ones keep their partial tokens);
        later ``submit`` calls raise."""
        for h in list(self._queue) + [h for h in self._slots if h is not None]:
            if not h.done:
                self._cancel(h)
        while self._pending:  # sync the device so nothing dangles
            self._harvest_one()
        self._closed = True

    def run(self) -> dict[int, list[int]]:
        """Deprecated: drain the queue; returns rid -> generated tokens.
        Use ``submit()``/``step()``/``drain()`` or ``RequestHandle.result()``."""
        warnings.warn(
            "ServingEngine.run() is deprecated; use submit()/step()/drain() "
            "or RequestHandle.result()", DeprecationWarning, stacklevel=2)
        return self.drain()

    def compile_resilient(self, program, backends: tuple[str, ...] = ("cuda", "torch")):
        """Hot-swap guardrail: compile (and validate) a tuned canonical
        program for this engine, degrading across ``backends`` in order.

        Each rung builds through a fresh ``Daisy`` on this engine's device
        (under ``'torch'`` the kernel recipes map onto torch ops) and runs
        once on random inputs before it is accepted; a failing rung falls
        through to the next, and each degradation is recorded on
        ``self.degradations``.  Returns a ``repro_torch.fault.DegradedCompile``.
        """
        from ..fault import compile_with_degradation

        res = compile_with_degradation(
            program, backends=backends, db=self.tuning_db,
            fault_plan=self.fault_plan, device=self.device)
        for b, _err in res.errors:
            self.degradations.append((getattr(program, "name", "?"), b, res.backend))
        return res

    def explain_kernels(self) -> str:
        """Pass-pipeline + contraction-plan report for this engine's config
        at its serving shape (content-cached, so repeated calls and
        re-created engines share one pipeline run until the database
        changes)."""
        return self._ctx.jitted(
            "serve.kernel_report",
            lambda: kernel_report(self.cfg, seq=self.scfg.max_len,
                                  batch=self.scfg.batch_slots, db=self.tuning_db),
            self.scfg.max_len, self.scfg.batch_slots,
            self.tuning_db.uid, self.tuning_db.generation,
        )

    # -- tuned logit-program composite -----------------------------------------
    def _build_aux(self, given: dict) -> dict:
        """Validate and stage the logit program's deployment operands.

        The engine owns ``X`` (the step's vocab-major logits) and reads
        ``Y``; every other input array of the *normalized* program is a
        deployment operand — taken from ``logit_inputs`` when given
        (shape-checked), zero-filled otherwise.  Unknown names are errors:
        a misspelt operand silently zero-filled would corrupt served tokens.
        """
        prog = self._daisy._normalized(self.logit_program)
        shapes = {a.name: tuple(a.shape) for a in prog.input_arrays}
        v, n = self.cfg.vocab, self.scfg.batch_slots
        for io in ("X", "Y"):
            if shapes.get(io) != (v, n):
                raise ValueError(
                    f"logit program must carry {io} of shape (vocab, "
                    f"batch_slots) = ({v}, {n}), got "
                    f"{shapes.get(io)} in {self.logit_program.name!r}")
        unknown = sorted(set(given) - set(shapes))
        if unknown:
            raise ValueError(
                f"logit_inputs name(s) {unknown} are not input arrays of "
                f"{self.logit_program.name!r} (has {sorted(shapes)})")
        aux: dict[str, torch.Tensor] = {}
        for name, shape in shapes.items():
            if name == "X":
                continue
            if name in given:
                arr = torch.as_tensor(given[name]).to(self.device, torch.float32)
                if tuple(arr.shape) != shape:
                    raise ValueError(
                        f"logit_inputs[{name!r}] has shape {tuple(arr.shape)}"
                        f", program expects {shape}")
            else:
                arr = torch.zeros(shape, dtype=torch.float32, device=self.device)
            aux[name] = arr.contiguous()
        return aux

    def _resolve_step_fns(self) -> None:
        """(Re)build the decode + logit-program composites when the tuning
        database's generation has moved — this IS the hot swap: a supervisor
        commit or rollback resolves a fresh composite on the next step.  The
        compiled program is cached under the program fingerprint and the
        recipes the generation resolves for its nests (with the backend and
        device it is lowered for), so a rollback, which restores the old
        recipe under a new generation, is a cache hit; the reference keys on
        the generation itself and rebuilds."""
        gen = self.tuning_db.generation
        if gen == self._prog_gen:
            return
        self._prog_gen = gen
        cfg, daisy, prog, aux = self.cfg, self._daisy, self.logit_program, self._prog_aux
        recipes = tuple(repr(n.recipe) for n in daisy.plan(prog).nests)
        pfn = self._ctx.jitted(
            "serve.logit_program", lambda: daisy.compile(prog)[0],
            self._prog_key, recipes, self.program_backend, str(self.device))

        def composite(sample_greedy: bool):
            def stepfn(params, states, tokens):
                logits, states = self._all_slots(
                    *self._full_logits(*M.decode_slots(cfg, params, states, tokens)))
                env = dict(aux)
                # (N, V) -> vocab-major (V, N); the program copies it into a
                # contiguous float32 tensor, the layout the nest kernel takes
                env["X"] = logits.T
                out = pfn(env)["Y"]
                if sample_greedy:
                    return torch.argmax(out, dim=0).to(torch.int32), states
                return out.T, states  # back to (N, V) for host sampling
            return stepfn

        self._dispatch_greedy = composite(True)
        self._dispatch_logits = composite(False)

    # -- the mesh ----------------------------------------------------------------
    def _source_ranks(self) -> list[int]:
        """The global rank whose outputs stand for each DP group's slots, in
        slot order (its ``model`` coordinate 0); one rank when every rank
        holds every slot."""
        mesh = self.mesh
        if not self._world:
            return [0]
        grid = np.asarray(mesh.ranks).reshape(tuple(mesh.shape.values()))
        dp = dp_axes(mesh)
        out = []
        for j in range(self.scfg.batch_slots // self._n_local):
            at = dict(zip(dp, np.unravel_index(j, tuple(mesh.shape[a] for a in dp))))
            out.append(int(grid[tuple(int(at.get(a, 0)) for a in mesh.axis_names)]))
        return out

    def _local_slot(self, i: int) -> int | None:
        """Slot ``i``'s index among this rank's slots, None if it is not one."""
        j = i - self._base
        return j if 0 <= j < self._n_local else None

    def _mine(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slots of a tensor over every slot."""
        if self._n_local == self.scfg.batch_slots:
            return full
        return full[self._base:self._base + self._n_local]

    def _all_slots(self, out: torch.Tensor, states):
        """(``out`` over this rank's slots gathered to every slot on every
        rank, states); as it is without a mesh of more than one rank."""
        if self._world:
            out = SH.world_gather(out, self._src)
        return out, states

    def _full_logits(self, logits: torch.Tensor, states):
        return M.full_vocab(self.cfg, logits), states

    def _sync_decisions(self) -> None:
        """Under a mesh of more than one rank: rank 0's overdue requests and
        cancellations, broadcast to every rank before the step."""
        if not self._world:
            return
        now = time.monotonic()
        box = [(sorted(r for r, h in self._inflight.items() if h._overdue(now)), self._cancels)]
        dist.broadcast_object_list(box, src=0)
        overdue, cancels = box[0]
        self._overdue_rids, self._cancels = set(overdue), []
        for rid in cancels:
            h = self._inflight.get(rid)
            if h is not None and not h.done:
                self._cancel(h)

    def _is_overdue(self, h: RequestHandle, now: float) -> bool:
        return h.rid in self._overdue_rids if self._world else h._overdue(now)

    def _request_cancel(self, h: RequestHandle) -> None:
        """``handle.cancel()``: at once without a mesh of more than one
        rank; else rank 0's request takes effect at the next step."""
        if self._world:
            self._cancels.append(h.rid)
        else:
            self._cancel(h)

    # -- internals -------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        # token-recurrent families can't mask a padded prompt token out of
        # the carried state, so they prefill at exact length
        if self.cfg.family in M.RECURRENT_FAMILIES:
            return n
        return next(b for b in self._buckets if b >= n)

    def _prefill(self, h: RequestHandle):
        """Bucket-padded prefill of one request into a fresh b=1 state;
        returns (last-valid-position logits (V,), state)."""
        cfg, scfg = self.cfg, self.scfg
        s = int(h.prompt.size)
        bucket = self._bucket_for(s)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :s] = h.prompt
        state = M.init_decode_state(cfg, 1, scfg.max_len, ring=False, device=self.device)
        if cfg.family == "audio":
            # stub frontend: encoder memory from zero frame embeddings
            emb = torch.zeros((1, cfg.frontend_len, cfg.d_model), dtype=M.dtype_of(cfg),
                              device=self.device)
            state["memory"] = M.encode(cfg, self.params, emb)
        logits, state = M.decode_step(cfg, self.params, state,
                                      torch.as_tensor(toks, device=self.device))
        # reset to the true length: the padded cache rows beyond it are
        # causally masked and get overwritten as decode proceeds
        state["len"] = s
        return M.full_vocab(cfg, logits[0, s - 1]), state

    def _sample_from(self, lf: np.ndarray) -> int:
        if self.scfg.temperature <= 0.0:
            return int(lf.argmax())
        p = np.exp((lf - lf.max()) / self.scfg.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _check_finite(self, lf: np.ndarray, h: RequestHandle) -> None:
        if not np.isfinite(lf).all():
            raise NonFiniteLogits(
                f"request {h.rid}: non-finite logits "
                f"(nan={int(np.isnan(lf).sum())}, inf={int(np.isinf(lf).sum())} "
                f"of {lf.size})")

    # -- terminal transitions -------------------------------------------------
    def _retire(self, h: RequestHandle, slot: int | None = None) -> None:
        self._inflight.pop(h.rid, None)
        if slot is not None and self._slots[slot] is h:
            self._slots[slot] = None

    def _finish(self, h: RequestHandle, slot: int | None = None) -> None:
        self.results[h.rid] = h.tokens
        self._retire(h, slot)

    def _fail(self, h: RequestHandle, err: BaseException, slot: int | None = None) -> None:
        h.state = RequestState.FAILED
        h.error = err
        self.failed[h.rid] = h
        self._retire(h, slot)

    def _timeout(self, h: RequestHandle, slot: int | None = None) -> None:
        h.state = RequestState.TIMED_OUT
        self._retire(h, slot)

    def _cancel(self, h: RequestHandle) -> None:
        h.state = RequestState.CANCELLED
        try:
            self._queue.remove(h)
        except ValueError:
            pass
        slot = next((i for i, s in enumerate(self._slots) if s is h), None)
        self._retire(h, slot)

    def _expire_queued(self) -> None:
        """TIMED_OUT sweep over requests still waiting for a slot."""
        now = time.monotonic()
        for h in [h for h in self._queue if self._is_overdue(h, now)]:
            self._queue.remove(h)
            self._timeout(h)

    def _admit(self) -> None:
        """Fill free slots from the queue: bucketed prefill, sample the
        first token, write the slot state.  A request whose prefill raises
        or whose prefill logits are non-finite fails alone."""
        while self._queue and None in self._slots:
            h = self._queue.popleft()
            if self._is_overdue(h, time.monotonic()):
                self._timeout(h)
                continue
            i = self._slots.index(None)
            try:
                fault = None if self.fault_plan is None else \
                    self.fault_plan.maybe_raise("serve.prefill", key=h.rid)
                lf, state = self._prefill_logits(h, i)
                if fault is not None and fault.kind == "nan":
                    lf = np.full_like(lf, np.nan)
                self._check_finite(lf, h)
                t0 = self._sample_from(lf)
                h.state = RequestState.RUNNING
                h._append(t0, self.scfg)
            except Exception as e:  # noqa: BLE001 — request-scoped isolation
                self._fail(h, e)
                continue
            if h.done:  # eos / max_new_tokens == 1: never occupies a slot
                self._finish(h)
                continue
            self._slots[i] = h
            j = self._local_slot(i)
            if j is not None:
                self._states = M.write_slot(self._states, j, state)
                self._tokens[j] = t0

    def _prefill_logits(self, h: RequestHandle, i: int):
        """``_prefill`` for slot ``i``: (its last logits on the host, whole
        vocabulary, fp32; the b=1 state, None on a rank that does not own
        the slot).  Under a mesh of more than one rank only the slot's
        owners prefill and the logits are broadcast from one of them; a
        prefill that raised there fails the request on every rank."""
        if not self._world:
            last, state = self._prefill(h)
            return last.float().cpu().numpy(), state
        src = self._src[i // self._n_local]
        buf = torch.zeros((self.cfg.vocab + 1,), dtype=torch.float32)  # (failed, logits)
        state, err = None, None
        if self._local_slot(i) is not None:
            try:
                last, state = self._prefill(h)
                buf[1:] = last.float().cpu()
            except Exception as e:  # noqa: BLE001 — reported to every rank below
                err, buf[0] = e, 1.0
        dist.broadcast(buf, src=src)
        if buf[0] != 0:
            raise err if err is not None else RuntimeError(
                f"request {h.rid}: prefill failed on rank {src}")
        return buf[1:].numpy(), state

    def _harvest_one(self) -> None:
        """Wait for the oldest in-flight step's tokens (or logits) and credit
        them to the handles that occupied each slot at dispatch time.  This
        is the only point the host waits on the device, and where deadlines
        expire and per-request failures are decided."""
        copy, live = self._pending.popleft()
        arr = _finish_copy(copy)
        now = time.monotonic()
        for i, h in live.items():
            if h.done:  # finished in a younger harvest; overshoot dropped
                continue
            if self._is_overdue(h, now):
                self._timeout(h, slot=i)
                continue
            try:
                fault = None if self.fault_plan is None else \
                    self.fault_plan.maybe_raise("serve.decode", key=h.rid)
                if arr.ndim == 1:  # greedy path: sampled tokens (N,)
                    tok = int(arr[i])
                else:  # sync path: logits (N, V), sample on the host
                    lf = arr[i]
                    lfault = self.fault_plan.maybe_raise(
                        "serve.logits", key=h.rid) if self.fault_plan else None
                    if (fault is not None and fault.kind == "nan") or (
                            lfault is not None and lfault.kind == "nan"):
                        lf = np.full_like(lf, np.nan)
                    self._check_finite(lf, h)
                    tok = self._sample_from(lf)
                    j = self._local_slot(i)
                    if j is not None:
                        self._tokens[j] = tok
                h._append(tok, self.scfg)
            except Exception as e:  # noqa: BLE001 — request-scoped isolation
                self._fail(h, e, slot=i)
                continue
            if h.done:
                self._finish(h, slot=i)

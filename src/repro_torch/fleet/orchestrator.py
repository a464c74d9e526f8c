"""The fleet orchestration host loop (counterpart of
``repro.fleet.orchestrator``): run a built scenario to completion across
preemptions.

* **One entry point.** ``run(built, devices, policy)`` dispatches to
  ``Engine.run_local``/``run_adaptive`` on one device or
  ``run_distributed``/``run_distributed_adaptive`` across the devices
  (``policy.driver="auto"`` picks by the device count and by whether the
  spec carries an exec ladder), or to ``run_ensemble`` for the catalog's
  ensemble entries. The devices are a mesh: torch devices, one a shard,
  which may share a card (``launch.mesh.make_sim_mesh``).
* **Checkpoints at window boundaries.** A
  :class:`~repro_torch.checkpoint.SimCheckpointer` saves the state (with
  the drained trace spans and the metrics records) every
  ``checkpoint_every`` windows, in the reference's layout, so a run that
  either package started resumes in the other.
* **Preemption.** Two lanes: an injected probe (``preempt=``) fired through
  the engine's window hook after any due save, and process death
  (SIGKILL), found at the next start through the ``fleet.json`` sidecar's
  missing clean flag.
* **Resume** restores the latest committed checkpoint (the unpadded
  state) and re-enters the driver on the surviving devices, booking
  ``RESHARD`` when their count changed; the result is byte-identical to the
  run that never stopped.
* **Caps and floors.** ``max_retries`` bounds the preemptions, the backoff
  (exponential, capped, through an injectable ``sleep``) spaces the
  attempts, and ``min_devices`` is the floor below which the run fails.
* **Fleet counters** are booked on the host (``MetricsStream.book``),
  never in the engine's counters, so a resumed state equals the
  uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np

from repro_torch.checkpoint import SimCheckpointer
from repro_torch.core import policy as pol_mod
from repro_torch.core.engine import Engine
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_sim_mesh

_SIDECAR = "fleet.json"


class PreemptionError(RuntimeError):
    """A shard-loss signal: the run lost devices mid-flight.

    Raised by the injected probe (or any window hook) to abort the current
    attempt; ``survivors`` is the surviving device count the orchestrator
    shrinks to before resuming."""

    def __init__(self, survivors: int, at_window: int | None = None):
        self.survivors = int(survivors)
        self.at_window = at_window
        super().__init__(
            f"preempted at window {at_window}: "
            f"{self.survivors} surviving device(s)")


class FleetError(RuntimeError):
    """Unrecoverable orchestration failure: the device floor was breached,
    the retry cap was exhausted, or the policy is invalid."""


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Declarative orchestration policy for one elastic run.

    ``driver`` selects the engine driver (``"auto"``: ``distributed`` or
    ``distributed_adaptive`` over more than one device, else ``local`` or
    ``adaptive``, the adaptive ones when the spec carries an exec ladder;
    ``"ensemble"`` runs the seeds driver, which neither checkpoints nor
    resumes).
    ``checkpoint_dir`` enables checkpoints every ``checkpoint_every``
    windows (the resume path needs them); ``kill_after`` passes through to
    the SIGKILL crash harness. ``max_retries`` caps preemptions per run,
    ``backoff``/``backoff_cap`` space the attempts (seconds; attempt k
    sleeps ``min(backoff * 2**(k-1), backoff_cap)``), and ``min_devices`` is
    the floor: a preemption that leaves fewer survivors fails instead of
    resuming."""

    driver: str = "auto"
    checkpoint_dir: str | None = None
    checkpoint_every: int = 8
    checkpoint_keep: int = 3
    kill_after: int | None = None
    max_windows: int = 10_000
    max_retries: int = 3
    backoff: float = 0.0
    backoff_cap: float = 30.0
    min_devices: int = 1

    _DRIVERS = ("auto", "local", "adaptive", "distributed",
                "distributed_adaptive", "ensemble")

    def __post_init__(self):
        if self.driver not in self._DRIVERS:
            raise FleetError(
                f"unknown driver {self.driver!r}; one of {self._DRIVERS}")
        if self.min_devices < 1:
            raise FleetError(
                f"min_devices must be >= 1, got {self.min_devices}")
        if self.max_retries < 0:
            raise FleetError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.checkpoint_every < 0:
            raise FleetError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}")


class OrchestratorResult(NamedTuple):
    """The run's outcome: ``state`` the final EngineState ((R, A, ...) for
    the ensemble driver), ``driver``, ``devices`` the device count of the
    finishing attempt, ``attempts`` (1: no preemption) and ``counts`` the
    host-side fleet books (``{"PREEMPT": n, "RESUME": n, "RESHARD": n}``)."""

    state: Any
    driver: str
    devices: int
    attempts: int
    counts: dict


class Orchestrator:
    """The elastic host loop: checkpoint, preempt, shrink, resume, finish.

    The streams and the trace ring's size (``trace_cap``/``drain_every``)
    belong to the orchestrator because they outlive each attempt's engine:
    the same stream objects attach to every attempt, and the checkpoints
    carry their host state across a preemption, so the records and the
    trace continue the uninterrupted run's.

    ``preempt(window, attempt) -> surviving device count | None`` is the
    injected shard-loss probe, called at every window boundary after any
    due save; an int aborts the attempt with :class:`PreemptionError`.
    """

    def __init__(self, policy: FleetPolicy | None = None, *,
                 trace_stream=None, metrics_stream=None,
                 preempt: Callable[[int, int], int | None] | None = None,
                 trace_cap: int = 0, drain_every: int = 16,
                 sleep: Callable[[float], None] = time.sleep):
        self.policy = FleetPolicy() if policy is None else policy
        self.trace_stream = trace_stream
        self.metrics_stream = metrics_stream
        self._preempt = preempt
        self.trace_cap = trace_cap
        self.drain_every = drain_every
        self._sleep = sleep
        self.counts = {"PREEMPT": 0, "RESUME": 0, "RESHARD": 0}

    # ------------------------------------------------------------- bookkeeping
    def _book(self, name: str, amount: int = 1) -> None:
        """Host-side fleet-counter booking (never the engine's counters)."""
        self.counts[name] += amount
        if self.metrics_stream is not None:
            self.metrics_stream.book(name, amount)

    def _sidecar_path(self, pol: FleetPolicy) -> str | None:
        if pol.checkpoint_dir is None:
            return None
        return os.path.join(pol.checkpoint_dir, _SIDECAR)

    def _write_sidecar(self, pol: FleetPolicy, n_devices: int,
                       clean: bool) -> None:
        """Record the attempt's device count and books (atomic rename):
        ``clean=False`` at attempt start, True only when the run completes,
        so a missing clean flag at the next start is the SIGKILL lane's
        preemption signal."""
        path = self._sidecar_path(pol)
        if path is None:
            return
        os.makedirs(pol.checkpoint_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"n_devices": n_devices, "clean": clean,
                       "counts": self.counts}, f)
        os.replace(tmp, path)

    def _read_sidecar(self, pol: FleetPolicy) -> dict | None:
        path = self._sidecar_path(pol)
        if path is None or not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # ---------------------------------------------------------------- dispatch
    def _resolve_driver(self, pol: FleetPolicy, spec, n_devices: int) -> str:
        if pol.driver != "auto":
            return pol.driver
        ladder = isinstance(spec.exec_policy, pol_mod.ExecPolicy)
        if n_devices > 1:
            return "distributed_adaptive" if ladder else "distributed"
        return "adaptive" if ladder else "local"

    def _dispatch(self, engine: Engine, driver: str, pol: FleetPolicy,
                  devices: list, state, rung):
        mw = pol.max_windows
        if driver == "local":
            return engine.run_local(mw, state=state)
        if driver == "adaptive":
            return engine.run_adaptive(mw, state=state, rung=rung)
        if driver == "distributed":
            return engine.run_distributed(devices, mw, state=state)
        if driver == "distributed_adaptive":
            return engine.run_distributed_adaptive(devices, mw, state=state,
                                                   rung=rung)
        raise FleetError(f"unknown driver {driver!r}")  # pragma: no cover

    def _hook(self, attempt: int):
        """The engine window hook wrapping the injected preemption probe."""
        probe = self._preempt
        if probe is None:
            return None

        def hook(window: int, _state) -> None:
            survivors = probe(window, attempt)
            if survivors is not None:
                raise PreemptionError(survivors, at_window=window)

        return hook

    # --------------------------------------------------------------------- run
    def run(self, built, devices=None, policy: FleetPolicy | None = None,
            seeds=None) -> OrchestratorResult:
        """Run a built scenario to completion.

        ``built`` is the ``(world, own, init_events, spec)`` tuple a
        catalog entry resolves to; ``devices`` the torch devices to start
        on, one a shard (default: every CUDA card, ``make_sim_mesh()``);
        ``policy`` overrides the constructor's; ``seeds`` is the ensemble
        driver's seed vector.

        Use a fresh ``checkpoint_dir`` per logical run: committed
        checkpoints found there are taken as this run's and resumed (the
        restart-after-SIGKILL contract).
        """
        pol = self.policy if policy is None else policy
        world, own, init_events, spec = built
        devices = (make_sim_mesh() if devices is None
                   else [resolve_device(d) for d in devices])
        if pol.driver == "ensemble":
            return self._run_ensemble(built, pol, seeds, devices)
        ck = None
        if pol.checkpoint_dir is not None and pol.checkpoint_every > 0:
            ck = SimCheckpointer(pol.checkpoint_dir,
                                 every=pol.checkpoint_every,
                                 keep=pol.checkpoint_keep,
                                 kill_after=pol.kill_after)

        # the SIGKILL lane: a sidecar without the clean flag means the
        # previous process died mid-run; restore its books and count the
        # death as the preemption it was
        prev = self._read_sidecar(pol)
        saved_n_dev = None
        if prev is not None and not prev.get("clean", False):
            for name, value in (prev.get("counts") or {}).items():
                if name in self.counts and value:
                    self._book(name, int(value) - self.counts[name])
            saved_n_dev = prev.get("n_devices")
            self._book("PREEMPT")

        attempt = 0
        while True:
            n_dev = len(devices)
            if n_dev < pol.min_devices:
                raise FleetError(
                    f"degraded below the device floor: {n_dev} survivor(s) "
                    f"< min_devices={pol.min_devices}")
            driver = self._resolve_driver(pol, spec, n_dev)
            engine = Engine(world, own, init_events, spec,
                            trace_cap=self.trace_cap,
                            trace_stream=self.trace_stream,
                            metrics_stream=self.metrics_stream,
                            drain_every=self.drain_every,
                            checkpointer=ck,
                            window_hook=self._hook(attempt),
                            device=devices[0])
            state = rung = None
            if ck is not None and ck.latest_step() is not None:
                rec = engine.restore()
                state, rung = rec.state, rec.rung
                self._book("RESUME")
                if saved_n_dev is not None and saved_n_dev != n_dev:
                    self._book("RESHARD")
            self._write_sidecar(pol, n_dev, clean=False)
            try:
                st = self._dispatch(engine, driver, pol, devices, state,
                                    rung)
            except PreemptionError as e:
                self._book("PREEMPT")
                attempt += 1
                if attempt > pol.max_retries:
                    raise FleetError(
                        f"retry cap exhausted: {attempt - 1} retries after "
                        f"{self.counts['PREEMPT']} preemption(s)") from e
                saved_n_dev = n_dev
                if e.survivors < n_dev:
                    devices = devices[:e.survivors]
                if pol.backoff > 0:
                    self._sleep(min(pol.backoff * 2 ** (attempt - 1),
                                    pol.backoff_cap))
                continue
            self._write_sidecar(pol, n_dev, clean=True)
            return OrchestratorResult(state=st, driver=driver, devices=n_dev,
                                      attempts=attempt + 1,
                                      counts=dict(self.counts))

    def _run_ensemble(self, built, pol: FleetPolicy, seeds,
                      devices) -> OrchestratorResult:
        """The seeds driver: no checkpoints and no probe (the engine
        refuses a trace stream and a checkpointer there)."""
        if seeds is None:
            raise FleetError("the ensemble driver needs a seed vector "
                             "(pass seeds=)")
        world, own, init_events, spec = built
        engine = Engine(world, own, init_events, spec,
                        metrics_stream=self.metrics_stream,
                        device=devices[0])
        st = engine.run_ensemble(np.asarray(seeds), pol.max_windows)
        return OrchestratorResult(state=st, driver="ensemble", devices=1,
                                  attempts=1, counts=dict(self.counts))

"""Self-healing training supervisor (``glom_tpu/resilience/supervisor.py``):
restart ``fit()`` until it finishes.

A production training job dies for reasons that have nothing to do with
the model: a poisoned batch NaNs the loss, a data worker crashes, a
filesystem hiccup kills a checkpoint read.  The supervisor converts those
deaths into restarts governed by a policy:

  * **exponential backoff with deterministic jitter** — retries never
    hammer a struggling filesystem, and a fleet of supervised jobs never
    thunders in sync (the jitter is seeded, so tests replay it exactly);
  * **crash-loop detection** — ``max_failures`` failures inside a sliding
    ``window_s`` means restarting is not helping (bad code, poisoned
    checkpoint lineage): give up loudly with a final forensics bundle
    instead of burning the fleet forever;
  * **resume-from-latest-valid** — before every retry the checkpoint
    directory is swept with :func:`~glom_tpu_torch.resilience.integrity.
    latest_valid_step`, quarantining torn/corrupt steps so the trainer's
    auto-resume lands on bytes that verify;
  * **evidence per restart** — each crash writes a ``crash_restart``
    forensics bundle (error + traceback + attempt arithmetic), and
    restart/giveup counters live in the shared obs registry next to the
    trainer's own metrics.

``fit_fn`` is called fresh on every attempt and must REBUILD its world
(Trainer, data iterator) rather than reuse a possibly-poisoned one —
recovery state flows exclusively through the checkpoint directory.  Clock,
sleep, and jitter RNG are injectable so the backoff/crash-loop arithmetic
is unit-testable without wall time.

Where the port differs: a sticky CUDA error (an illegal address, error 700;
a device-side assert; an unspecified launch failure) poisons the process's
CUDA context, and every later call on the card fails with it, so a restart
inside the process cannot succeed.  :func:`classify_failure` names it
``cuda_fatal`` and the supervisor gives up at once, with that reason in its
bundle and in :class:`GiveUp`'s message: recovering from it needs a
supervisor outside the process (a fresh process resumes from the
checkpoint directory).
"""

from __future__ import annotations

import random
import re
import time
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from glom_tpu_torch.obs.triggers import TRIGGER_CRASH_RESTART
from glom_tpu_torch.resilience import integrity


class GiveUp(RuntimeError):
    """The crash-loop policy exhausted: restarting is not helping.  The
    final underlying failure is the ``__cause__``."""


class PreemptionError(RuntimeError):
    """A host/domain was preempted (the scheduler took the machine back) —
    the restartable-by-definition failure class.  The elastic layer
    (:mod:`glom_tpu_torch.resilience.elastic`) subclasses this; the base
    lives here so :func:`classify_failure` needs no import of the elastic
    module."""


# -- restart-reason taxonomy ------------------------------------------------
# One undifferentiated `supervisor_restarts` count cannot answer the MTTR
# questions chaos reports ask ("is the fleet dying to preemption or to our
# own NaNs?").  Every restart is additionally counted under
# `supervisor_restarts_<reason>` (minted through MetricRegistry.labeled so
# a hostile reason string can never grow /metrics unboundedly).
REASON_PREEMPT = "preempt"      # PreemptionError: scheduler reclaim
REASON_NAN_HALT = "nan_halt"    # trainer halt_on_nan tripped
REASON_IO_ERROR = "io_error"    # OSError class: filesystem/network (incl.
                                # injected FaultError, an OSError subclass)
REASON_CRASH = "crash"          # everything else: code/data bugs
REASON_CUDA_FATAL = "cuda_fatal"  # a sticky CUDA error: never restarted in-process

# What torch (or a kernel wrapper's ``_build.check``) says of an error that
# leaves the process's CUDA context unusable: the cudaError_t names and
# strings of the sticky class (700 illegal address, 710 device-side assert,
# 715 illegal instruction, 716 misaligned address, 719 launch failure)
_STICKY_CUDA = re.compile(
    r"illegal memory access|illegal address|device-side assert|illegal instruction|"
    r"misaligned address|unspecified launch failure|CUDA error (700|710|715|716|719)\b")


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` reports a CUDA error that poisons the context."""
    return isinstance(exc, RuntimeError) and bool(_STICKY_CUDA.search(str(exc)))


def classify_failure(exc: BaseException) -> str:
    """Map a fit() failure to its restart-reason label.  NonFiniteError is
    matched by NAME on purpose: importing the trainer (and with it torch's
    kernels) into this stdlib-light module just for an isinstance would be
    the tail wagging the dog."""
    if is_sticky_cuda_error(exc):
        return REASON_CUDA_FATAL
    if isinstance(exc, PreemptionError):
        return REASON_PREEMPT
    if type(exc).__name__ == "NonFiniteError":
        return REASON_NAN_HALT
    if isinstance(exc, OSError):
        return REASON_IO_ERROR
    return REASON_CRASH


@dataclass(frozen=True)
class RestartPolicy:
    """Restart arithmetic.  ``max_failures`` failures within the sliding
    ``window_s`` seconds => give up.  Backoff before attempt ``k`` (0-based
    failure count) is ``min(base * factor**k, max) * (1 ± jitter)``."""

    max_failures: int = 5
    window_s: float = 600.0
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    jitter: float = 0.1

    def __post_init__(self):
        if self.max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, got {self.max_failures}")
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def backoff_s(self, failure_index: int, rng: random.Random) -> float:
        base = min(
            self.backoff_base_s * (self.backoff_factor ** failure_index),
            self.backoff_max_s,
        )
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(base, 0.0)


class Supervisor:
    """Run ``fit_fn`` under a :class:`RestartPolicy`.

    ``fit_fn()`` takes no arguments and returns fit's result; it is invoked
    fresh per attempt (see module docstring).  ``checkpoint_dir`` enables
    the pre-restart integrity sweep; ``registry``/``forensics``/
    ``observer`` splice into the shared obs stack.  ``clock``/``sleep``/
    ``seed`` make every time-dependent decision injectable.
    """

    def __init__(
        self,
        fit_fn: Callable[[], Any],
        *,
        policy: Optional[RestartPolicy] = None,
        checkpoint_dir: Optional[str] = None,
        registry=None,
        forensics=None,
        observer: Optional[integrity.IntegrityObserver] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        seed: int = 0,
    ):
        self.fit_fn = fit_fn
        self.policy = policy if policy is not None else RestartPolicy()
        self.checkpoint_dir = checkpoint_dir
        self.registry = registry
        self.forensics = forensics
        self.observer = observer if observer is not None else (
            integrity.IntegrityObserver(registry=registry, forensics=forensics)
        )
        self._clock = clock
        self._sleep = sleep
        self._rng = random.Random(seed)
        self.restarts = 0          # completed restart decisions
        self.last_backoff_s = 0.0

    # -- telemetry ---------------------------------------------------------
    def _count(self, name: str, help: str) -> None:
        if self.registry is not None:
            self.registry.counter(name, help=help).inc()

    def _bundle(self, step: int, detail: dict) -> None:
        """One ``crash_restart`` bundle per restart (and one for the final
        giveup).  Direct capture, no debounce: each restart is a distinct
        incident and the contract is evidence per restart; the
        policy's max_failures bounds the count."""
        if self.forensics is not None:
            self.forensics.capture(TRIGGER_CRASH_RESTART, step, detail,
                                   trace=False)

    # -- the loop ----------------------------------------------------------
    def run(self) -> Any:
        failures: deque = deque()
        while True:
            try:
                return self.fit_fn()
            except (KeyboardInterrupt, SystemExit):
                raise  # operator intent, never a restartable failure
            except Exception as e:
                now = self._clock()
                failures.append(now)
                while failures and now - failures[0] > self.policy.window_s:
                    failures.popleft()
                n_fail = len(failures)
                reason = classify_failure(e)
                detail = {
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": "".join(traceback.format_exception(
                        type(e), e, e.__traceback__)),
                    "reason": reason,
                    "failures_in_window": n_fail,
                    "window_s": self.policy.window_s,
                    "restarts_so_far": self.restarts,
                }
                if reason == REASON_CUDA_FATAL:
                    # the context is poisoned: a retry in this process fails
                    # the same way, so give up at once and name the cause
                    self._count(
                        "supervisor_giveups",
                        "supervised runs abandoned by crash-loop detection",
                    )
                    self._bundle(self.restarts, dict(detail, outcome="giveup"))
                    raise GiveUp(
                        f"giving up at once: a sticky CUDA error poisons this process's "
                        f"CUDA context, so no restart inside it can succeed; restart the "
                        f"process (a supervisor outside it) to resume from the checkpoint "
                        f"directory (cause: {type(e).__name__}: {e})"
                    ) from e
                if n_fail >= self.policy.max_failures:
                    self._count(
                        "supervisor_giveups",
                        "supervised runs abandoned by crash-loop detection",
                    )
                    self._bundle(self.restarts, dict(detail, outcome="giveup"))
                    raise GiveUp(
                        f"giving up after {n_fail} failures within "
                        f"{self.policy.window_s:.0f}s (last: "
                        f"{type(e).__name__}: {e})"
                    ) from e
                self._count("supervisor_restarts",
                            "supervised fit() restarts after a crash")
                if self.registry is not None:
                    # per-reason split of the same count (labeled mint keeps
                    # the family's cardinality bounded): chaos MTTR reports
                    # read these to separate preemption from crash from
                    # NaN-halt instead of one undifferentiated total
                    self.registry.counter(
                        self.registry.labeled("supervisor_restarts_", reason),
                        help="supervised fit() restarts, split by failure "
                             "reason (preempt|nan_halt|io_error|crash)",
                    ).inc()
                self._bundle(self.restarts, dict(detail, outcome="restart"))
                if self.checkpoint_dir:
                    # quarantine torn/corrupt steps NOW so the retry's
                    # auto-resume anchors on the newest step that verifies
                    integrity.latest_valid_step(
                        self.checkpoint_dir, observer=self.observer
                    )
                delay = self.policy.backoff_s(self.restarts, self._rng)
                self.last_backoff_s = delay
                if self.registry is not None:
                    self.registry.gauge(
                        "supervisor_backoff_s",
                        help="backoff slept before the most recent restart",
                        unit="seconds",
                    ).set(delay)
                self.restarts += 1
                self._sleep(delay)

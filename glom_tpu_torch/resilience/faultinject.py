"""Seeded, deterministic fault injection: the port's copy of
``glom_tpu/resilience/faultinject.py`` (stdlib only, no import of either
package's numerics).

A :class:`FaultPlan`, parsed from a compact spec string, arms named
*injection sites* that production code threads through its seams.  The
same spec and seed fire the same faults, and draw the same :func:`uniform`
values, as ``glom_tpu``'s module does: a chaos scenario is a deterministic
test, and one plan drives both packages alike.

Spec grammar (entries separated by ``;``)::

    site:kind[@[step]N][*COUNT]

      ckpt_write:torn@step120       torn artifact write at save step 120
      data:nan_batch@37             NaN batch on the 37th batch drawn
      reload:io_error*3             I/O error on the first 3 reload polls
      data:delay@5*2                delayed batches 5 and 6

``@N`` pins the fault to occurrence ``N`` of the site (the step number the
site reports, or the site's own 1-based call counter when it reports
none); ``*COUNT`` fires it ``COUNT`` consecutive times (default 1).  A
fault with neither fires on the site's first occurrence.

Sites (the names production code passes to :func:`fire`):

  ==========  ============================  =================================
  site        kinds                         threaded into
  ==========  ============================  =================================
  ckpt_write  torn, bitflip                 ``checkpoint.save`` (artifact
                                            corrupted after the atomic write
                                            — the "crashed mid-write /
                                            silent media corruption" class)
  data        nan_batch, drop_batch,        ``training/data.py`` batch
              delay, crash                  iterators (poisoned / lost /
                                            stalled input, pipeline crash)
  reload      io_error, corrupt_manifest    ``serving/engine.py`` hot-reload
                                            watcher polls
  candidate   delay, error                  ``serving/deploy.py`` candidate
                                            executes (a regressing shadow/
                                            canary deploy candidate)
  candidate_load  bitflip                   ``serving/deploy.py`` candidate
                                            load (weights negated after the
                                            integrity check)
  ==========  ============================  =================================

The elastic sites (``host_preempt``, ``coordinator_loss``,
``heartbeat_delay``, ``shrink_restart``) fire in
:mod:`glom_tpu_torch.resilience.elastic` (the context's tick and the
supervisor's re-plan), as in ``glom_tpu``, so one spec arms both packages.

Arming is process-global (:func:`arm` / :func:`disarm` / the
:func:`injected` context manager): the sites live deep inside library code
where no plan object could be threaded without polluting every signature.
Disarmed cost is one module-global ``is None`` check per site call —
nothing on the hot path pays for the capability.

Stdlib only.
"""

from __future__ import annotations

import contextlib
import random
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

KINDS = {
    "ckpt_write": ("torn", "bitflip"),
    "data": ("nan_batch", "drop_batch", "delay", "crash"),
    "reload": ("io_error", "corrupt_manifest"),
    # deploy-candidate regression (serving/deploy.py): fired once
    # per candidate execute (shadow mirror or live canary batch) —
    # "delay" makes the candidate measurably slow (client-visible latency
    # on canary traffic, never an error), "error" fails the execute
    "candidate": ("delay", "error"),
    # deploy-candidate WEIGHT corruption (serving/deploy.py):
    # fired once at candidate load, AFTER integrity verification — the
    # candidate loads clean and serves without errors but computes
    # garbage; only the shadow lane's quality comparison can catch it
    "candidate_load": ("bitflip",),
    # elastic multi-host sites (resilience/elastic.py): a domain preempted,
    # the coordinator silent, a beat late, a restart with fewer/more hosts
    "host_preempt": ("kill",),
    "coordinator_loss": ("lost",),
    "heartbeat_delay": ("delay",),
    "shrink_restart": ("shrink", "grow"),
}


class FaultError(OSError):
    """The exception injected faults raise (``reload:io_error``,
    ``data:crash``).  An OSError subclass so code hardened against real
    transient I/O errors handles the injected kind identically."""


@dataclass
class Fault:
    """One armed fault: fire at occurrences ``[at, at + count)`` of
    ``site`` (``at=None`` => the site's first occurrence)."""

    site: str
    kind: str
    at: Optional[int] = None
    count: int = 1
    fired: int = field(default=0, compare=False)

    def matches(self, occurrence: int) -> bool:
        if self.fired >= self.count:
            return False
        start = self.at if self.at is not None else 1
        return start <= occurrence < start + self.count

    def spec(self) -> str:
        s = f"{self.site}:{self.kind}"
        if self.at is not None:
            s += f"@{self.at}"
        if self.count != 1:
            s += f"*{self.count}"
        return s


_ENTRY = re.compile(
    r"^(?P<site>[a-z_]+):(?P<kind>[a-z_]+)"
    r"(?:@(?:step)?(?P<at>\d+))?"
    r"(?:\*(?P<count>\d+))?$"
)


class FaultPlan:
    """A parsed, seeded set of faults plus per-site occurrence counters.

    ``fire(site, step=...)`` consumes one occurrence of ``site`` and
    returns the kind of the first eligible fault (marking one firing) or
    None.  Counters and firing state make replay deterministic: parsing
    the same spec with the same seed and driving the sites identically
    yields the identical fault sequence.  Thread-safe — the serving
    watcher and a training loop may share one armed plan.
    """

    def __init__(self, faults: List[Fault], *, seed: int = 0, spec: str = ""):
        self.faults = faults
        self.seed = seed
        self.spec = spec
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        faults = []
        for raw in spec.split(";"):
            entry = raw.strip()
            if not entry:
                continue
            m = _ENTRY.match(entry)
            if m is None:
                raise ValueError(
                    f"bad fault spec entry {entry!r}; expected "
                    f"'site:kind[@[step]N][*COUNT]'"
                )
            site, kind = m.group("site"), m.group("kind")
            if site not in KINDS:
                raise ValueError(
                    f"unknown fault site {site!r}; one of {sorted(KINDS)}"
                )
            if kind not in KINDS[site]:
                raise ValueError(
                    f"unknown kind {kind!r} for site {site!r}; one of "
                    f"{KINDS[site]}"
                )
            at = m.group("at")
            count = m.group("count")
            faults.append(Fault(
                site, kind,
                at=int(at) if at is not None else None,
                count=int(count) if count is not None else 1,
            ))
        return cls(faults, seed=seed, spec=spec)

    def fire(self, site: str, *, step: Optional[int] = None) -> Optional[str]:
        """One occurrence of ``site``: ``step`` is the site's own notion of
        position (save step, batch index); when None the plan counts calls
        per site, 1-based.  Returns the fired fault's kind or None."""
        with self._lock:
            self._calls[site] = self._calls.get(site, 0) + 1
            occurrence = step if step is not None else self._calls[site]
            for f in self.faults:
                if f.site == site and f.matches(occurrence):
                    f.fired += 1
                    return f.kind
        return None

    def uniform(self, site: str, lo: float, hi: float) -> float:
        """Deterministic per-(seed, site, draw) uniform — fault parameters
        (delay durations, flip offsets) never consult global RNG state."""
        with self._lock:
            n = self._calls.get(site, 0)
        return random.Random(f"{self.seed}:{site}:{n}").uniform(lo, hi)

    def summary(self) -> dict:
        return {
            "seed": self.seed,
            "faults": [{"spec": f.spec(), "fired": f.fired} for f in self.faults],
        }


# -- process-global arming -------------------------------------------------
_PLAN: Optional[FaultPlan] = None


def arm(plan, *, seed: int = 0) -> FaultPlan:
    """Arm a :class:`FaultPlan` (or a spec string, parsed with ``seed``)
    process-wide.  Returns the armed plan."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan, seed=seed)
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def armed() -> bool:
    return _PLAN is not None


def fire(site: str, *, step: Optional[int] = None) -> Optional[str]:
    """The site hook: None when disarmed (the only cost on production
    paths), else the armed plan's decision for this occurrence."""
    if _PLAN is None:
        return None
    return _PLAN.fire(site, step=step)


def uniform(site: str, lo: float, hi: float) -> float:
    if _PLAN is None:
        return lo
    return _PLAN.uniform(site, lo, hi)


@contextlib.contextmanager
def injected(spec: str, *, seed: int = 0):
    """Scoped arming for tests/scenarios: disarms on exit even when the
    body raises (an escaped armed plan would poison later tests)."""
    plan = arm(spec, seed=seed)
    try:
        yield plan
    finally:
        disarm()

"""Heat-based promotion of hot (program, plan, context) pairs to the
compiled tier.

The :class:`CompileManager` is owned by a
:class:`~repro_torch.runtime.serving.ServingRuntime` (or any caller of
``run_batch(..., compiler=...)``). Every batch served on the interpreter
tier warms a heat counter keyed by (source-program fingerprint, chosen-plan
fingerprint, execution-context fingerprint, backend); once a pair crosses
``threshold`` invocations it is lowered
(:func:`repro_torch.compiled.lower.lower_program`) and the resulting
:class:`~repro_torch.compiled.lower.LoweredProgram` is cached in an
:class:`~repro_torch.api.cache.ArtifactCache`, content-addressed with the same
scheme the disk :class:`~repro_torch.runtime.store.PlanStore` uses
(:func:`~repro_torch.runtime.store.content_address`) so the two tiers' artifacts
correlate in telemetry.

Correctness under statistics/data movement does NOT depend on this cache:
the compiled hooks re-check the (instance, stats version, data version)
epoch per probe index on every execution (see ``compiled.exec``). The
manager's :meth:`~CompileManager.invalidate_tables` — driven by the same
drift events that invalidate the serving SiteCache — is hygiene: it drops
artifacts (and their heat) for drifted tables so a recompiled plan starts
cold rather than inheriting stale promotion state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, FrozenSet, Optional, Tuple

from ..api.cache import (ArtifactCache, program_fingerprint, program_sites,
                         program_tables)
from ..obs.metrics import MetricsRegistry, registry_counter
from ..obs.trace import NOOP_TRACER
from ..runtime.store import content_address
from .lower import LoweredProgram, lower_program, resolve_backend

__all__ = ["CompileManager", "CompiledArtifact"]

DEFAULT_COMPILE_THRESHOLD = 3


@dataclasses.dataclass
class CompiledArtifact:
    """One cached lowering. ``lowered`` is None when the plan had no
    columnar region — remembered so the manager never re-lowers a
    plan that cannot benefit."""

    key: Tuple
    address: str                      # content address (PlanStore vocabulary)
    lowered: Optional[LoweredProgram]
    compile_s: float
    tables: FrozenSet[str]            # base tables the plan touches


class CompileManager:
    """Promote hot (program, plan, context) pairs to compiled executables."""

    # registry-backed telemetry counters (repro_torch.obs.metrics)
    compiles = registry_counter()
    noop_lowerings = registry_counter()  # plans lowered to 0 columnar loops
    compile_s_total = registry_counter()
    compiled_batches = registry_counter()
    interpreted_batches = registry_counter()

    def __init__(self, session, threshold: int = DEFAULT_COMPILE_THRESHOLD,
                 backend: Optional[str] = None, max_artifacts: int = 64):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.session = session
        # must exist before the registry_counter descriptors are written
        self.metrics = MetricsRegistry()
        self.threshold = int(threshold)
        self.backend = resolve_backend(backend)
        self.artifacts = ArtifactCache(max_artifacts)
        self._heat: Dict[Tuple, int] = {}
        # zero the registry-backed counters
        self.compiles = 0
        self.noop_lowerings = 0
        self.compile_s_total = 0.0
        self.compiled_batches = 0
        self.interpreted_batches = 0

    # -------------------------------------------------------------- identity
    def key_for(self, exe) -> Tuple:
        """(source fp, plan fp, context fp address, backend) — the promotion
        unit. The plan fingerprint makes a feedback-driven plan swap start
        cold; the context fingerprint keeps a serving-context plan's heat
        separate from a one-shot compile of the same program."""
        ctx_fp = exe.context.fingerprint(sites=program_sites(exe.source))
        return (program_fingerprint(exe.source),
                program_fingerprint(exe.program),
                content_address(ctx_fp),
                self.backend)

    # ------------------------------------------------------------- promotion
    def lowered_for(self, exe, n_invocations: int = 1
                    ) -> Optional[LoweredProgram]:
        """The compiled executable for ``exe`` if it is hot (compiling it on
        first promotion), else None — the caller stays on the interpreter
        tier. ``n_invocations`` is how many invocations this batch carries;
        heat accumulates per invocation, not per batch."""
        key = self.key_for(exe)
        art = self.artifacts.get(key)
        if art is None:
            heat = self._heat.get(key, 0) + max(1, int(n_invocations))
            self._heat[key] = heat
            if heat < self.threshold:
                self.interpreted_batches += 1
                return None
            tracer = getattr(self.session, "tracer", NOOP_TRACER)
            t0 = time.perf_counter()
            with tracer.span("lowering", program=exe.program.name,
                             backend=self.backend):
                lowered = lower_program(exe.program, self.backend)
            dt = time.perf_counter() - t0
            if lowered.n_columnar == 0:
                # nothing data-parallel to run: remember the verdict so the
                # plan is never re-lowered, and stay on the interpreter
                lowered = None
                self.noop_lowerings += 1
            else:
                self.compiles += 1
                self.compile_s_total += dt
            art = CompiledArtifact(
                key=key, address=content_address(key), lowered=lowered,
                compile_s=dt, tables=frozenset(program_tables(exe.program)))
            self.artifacts.put(key, art)
        if art.lowered is None:
            self.interpreted_batches += 1
        else:
            self.compiled_batches += 1
        return art.lowered

    # ----------------------------------------------------------- maintenance
    def invalidate_tables(self, tables) -> int:
        """Drop artifacts (and promotion heat) touching ``tables`` — called
        on the same drift events that invalidate the serving SiteCache."""
        ts = set(tables)
        dropped = []

        def pred(key, art):
            if art.tables & ts:
                dropped.append(key)
                return True
            return False

        n = self.artifacts.invalidate(pred)
        for k in dropped:
            self._heat.pop(k, None)
        return n

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, object]:
        t = {"backend": self.backend,
             "threshold": self.threshold,
             "compiles": self.compiles,
             "noop_lowerings": self.noop_lowerings,
             "compile_s_total": self.compile_s_total,
             "compiled_batches": self.compiled_batches,
             "interpreted_batches": self.interpreted_batches,
             "hot_candidates": len(self._heat)}
        t.update({f"artifact_{k}": v
                  for k, v in self.artifacts.stats().items()})
        return t

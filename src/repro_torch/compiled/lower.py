"""Lowering: turn a winning plan's data-parallel regions into columnar
vectorized executables.

``lower_program`` walks a (rewritten) :class:`~repro_torch.core.regions.Program`,
asks :func:`~repro_torch.core.regions.compilability` for the per-region verdict,
and binds every ``"columnar"`` loop to a :class:`CompiledLoop` — the loop's
precomputed :class:`~repro_torch.core.vectorize.LoopPlan` plus kernel-backed
:class:`~repro_torch.core.vectorize.LoopHooks` (epoch-cached probe indices, the
``join_probe``/``segment_reduce`` kernels through ``kernels.ops``, or the
``kernels.ref`` numpy reference path on the ``"numpy"`` backend). Regions
the analysis rejects — ``while`` guards, early exits, nested loops, update
bodies — carry no binding and stay on the row-at-a-time interpreter; the
:class:`~repro_torch.compiled.exec.SplicingInterpreter` splices the compiled
segments around them at run time.

The lowering is *semantically checked* against F-IR: an accumulator is only
eligible for a kernel fold when :func:`repro_torch.core.fir.fold_accumulators`
derives the same operator for it that the loop plan matched — two
independent analyses must agree before a fold leaves the (bit-exact)
sequential float64 path. Even then the fold runs behind a runtime exactness
gate (integer deltas within fp32's exact range); anything else falls back
to the default accumulate, which is itself columnar.

Simulated-time charging is NOT part of this module: every compiled loop
executes through :func:`repro_torch.core.vectorize.exec_loop_plan`, the one code
path the fast interpreter also runs, so compiled and interpreted executions
agree on the clock by construction.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

from ..core.fir import fold_accumulators
from ..core.regions import (CompileNote, LoopRegion, Program, Region,
                            compilability)
from ..core.vectorize import LoopHooks, LoopPlan, analyze_loop

__all__ = ["CompiledLoop", "LoweredProgram", "lower_program",
           "resolve_backend", "available_backends"]


def available_backends() -> Tuple[str, ...]:
    """Backends this process can lower to, preferred first."""
    return ("kernels", "numpy")


def resolve_backend(requested: Optional[str] = None) -> str:
    """Pick the execution backend: ``"kernels"`` (torch dispatch through
    ``kernels.ops`` — the CUDA kernels for tables on the card, their plain
    torch versions for CPU tables) by default, or the ``kernels.ref`` numpy
    path. The ``REPRO_COMPILED_BACKEND`` environment variable overrides the
    default; an explicit ``requested`` overrides both."""
    avail = available_backends()
    choice = requested or os.environ.get("REPRO_COMPILED_BACKEND") or avail[0]
    if choice not in ("kernels", "numpy"):
        raise ValueError(f"unknown compiled backend {choice!r}; "
                         f"expected 'kernels' or 'numpy'")
    if choice not in avail:
        raise RuntimeError(f"backend {choice!r} unavailable; "
                           f"available: {avail}")
    return choice


def _stmt_free_vars(stmt) -> set:
    """Free variables of one planned statement (guards included)."""
    if isinstance(stmt, tuple) and stmt[0] == "__guard__":
        return set(stmt[1].free_vars())
    out = set()
    for attr in ("expr", "val", "keyexpr", "valexpr"):
        e = getattr(stmt, attr, None)
        if e is not None:
            out |= set(e.free_vars())
    return out


def _kernel_foldable_accs(plan: LoopPlan,
                          fold_ops: Optional[Dict[str, str]]) -> frozenset:
    """Accumulators eligible for a ``segment_reduce`` kernel fold.

    Requirements (all conservative — a miss only means the default
    float64-cumsum accumulate, which is already columnar and bit-exact):

      * the F-IR cross-check agrees the accumulator is ``acc = acc + e``
        (``fold_accumulators`` derives ``"+"`` independently of the loop
        plan's pattern match);
      * no OTHER planned statement (guard predicates included) references
        the accumulator — a kernel fold produces only the final scalar, so
        a body read of the running value has nowhere to come from.
    """
    if fold_ops is None:
        return frozenset()
    out = set()
    for acc in plan.accumulators:
        if fold_ops.get(acc) != "+":
            continue
        referenced_elsewhere = False
        skipped_own_update = False
        for stmt, _guard in plan.stmts:
            # skip exactly ONE statement: the accumulator's defining update
            # (a later re-assign of the same name reads the running column,
            # which a kernel fold does not produce — that counts as a ref)
            if not skipped_own_update and not isinstance(stmt, tuple) \
                    and getattr(stmt, "target", None) == acc:
                skipped_own_update = True
                continue
            if acc in _stmt_free_vars(stmt):
                referenced_elsewhere = True
                break
        if not referenced_elsewhere:
            out.add(acc)
    return frozenset(out)


@dataclasses.dataclass
class CompiledLoop:
    """One columnar loop binding: plan + kernel-backed hooks + telemetry."""

    region: LoopRegion
    plan: LoopPlan
    hooks: LoopHooks
    backend: str
    fold_ops: Dict[str, str]          # F-IR cross-check result per accumulator
    kernel_fold_accs: frozenset       # accs eligible for a kernel fold
    # execution telemetry (filled by the hooks in compiled.exec)
    executions: int = 0
    kernel_probes: int = 0
    kernel_folds: int = 0
    index_rebuilds: int = 0


class LoweredProgram:
    """A program with its columnar loops bound to compiled executables.

    The binding is by region *identity* (``id``) against THIS program
    object's tree — a ``LoweredProgram`` always runs its own ``program``,
    so content-addressed artifact reuse across Executables is safe."""

    def __init__(self, program: Program, backend: str,
                 loops: Dict[int, CompiledLoop],
                 notes: Dict[Tuple, CompileNote], lower_s: float):
        self.program = program
        self.backend = backend
        self._loops = loops
        self.notes = notes
        self.lower_s = lower_s
        # tier telemetry
        self.columnar_execs = 0       # loops served by a compiled segment
        self.fallback_execs = 0       # lowered loops that fell back at run
        self.interpreter_regions = sum(
            1 for n in notes.values() if n.verdict == "interpreter")

    def loop_for(self, r: Region) -> Optional[CompiledLoop]:
        return self._loops.get(id(r))

    @property
    def n_columnar(self) -> int:
        return len(self._loops)

    def run(self, env, params=None):
        """Execute on ``env`` through the splicing interpreter."""
        from .exec import SplicingInterpreter
        return SplicingInterpreter(env, self).run(self.program, params)

    def describe(self) -> str:
        return (f"LoweredProgram[{self.program.name}] backend={self.backend}: "
                f"{self.n_columnar} columnar loop(s), "
                f"{self.interpreter_regions} interpreter region(s)")


def lower_program(program: Program,
                  backend: Optional[str] = None) -> LoweredProgram:
    """Lower every columnar-verdict loop of ``program``; regions outside the
    columnar vocabulary keep their interpreter binding (tiered fallback)."""
    from .exec import make_hooks
    backend = resolve_backend(backend)
    t0 = time.perf_counter()
    notes = compilability(program)
    loops: Dict[int, CompiledLoop] = {}

    def walk(r: Region) -> None:
        if isinstance(r, LoopRegion):
            note = notes.get(r.key())
            # note lookup is by structural key; two identically-shaped loops
            # share a verdict but each gets its own binding (identity map)
            if note is not None and note.verdict == "columnar":
                plan = analyze_loop(r, {})
                if plan is not None:
                    fold_ops = fold_accumulators(r) or {}
                    cl = CompiledLoop(
                        region=r, plan=plan, hooks=LoopHooks(),
                        backend=backend, fold_ops=fold_ops,
                        kernel_fold_accs=_kernel_foldable_accs(plan, fold_ops
                                                               or None))
                    cl.hooks = make_hooks(cl)
                    loops[id(r)] = cl
        for c in r.children():
            walk(c)

    walk(program.body)
    return LoweredProgram(program, backend, loops, notes,
                          lower_s=time.perf_counter() - t0)

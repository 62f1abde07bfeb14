"""Declarative design space over Klessydra-T coprocessor configurations
(the port's copy of ``repro.kvi.dse.space``).

The paper's contribution is not one configuration but a *sweep*: SPM
interface replication (M), MFU replication (F), lane width (D) and
sub-word precision across the shared / symmetric-MIMD / heterogeneous-
MIMD interconnection schemes, each judged on cycles, hardware cost and
energy. A :class:`DesignSpace` declares that grid once; its deterministic
:meth:`~DesignSpace.points` enumeration feeds the sweep driver
(the reference's ``repro.kvi.dse.sweep``), the cost model (:mod:`repro_torch.kvi.dse.cost`)
and the Pareto analysis (the reference's ``repro.kvi.dse.pareto``).

A :class:`DesignPoint` couples the *data* precision of the workload to
the *hardware* sub-word capability: an 8-bit point runs 8-bit programs
on a datapath with full sub-word lanes (``subword_bits=8``), while a
32-bit point carries no sub-word hardware at all — so the precision axis
trades real area against real cycles, exactly the SPEED-style
multi-precision trade-off.

Invalid combinations are rejected eagerly (``ValueError`` naming the
field/axis); SPM-capacity feasibility against a concrete workload is a
separate *preflight* (:func:`preflight_point`) reusing the lowering
allocator's :class:`~repro_torch.kvi.lowering.SpmOverflowError` check.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.configs.base import KlessydraConfig

SCHEMES = ("shared", "sym_mimd", "het_mimd")

_VALID_PRECISIONS = (8, 16, 32)


def scheme_config(scheme: str, D: int = 4, spm_kbytes: int = 64,
                  M: int = 3, F: Optional[int] = None,
                  subword_bits: int = 8,
                  fu_counts: Tuple[Tuple[str, int], ...] = (),
                  name: Optional[str] = None, **kw) -> KlessydraConfig:
    """One scheme name -> a validated :class:`KlessydraConfig`.

    ``M`` is the SPMI replication of the MIMD schemes (the shared scheme
    always has M=F=1); ``F`` overrides the heterogeneous scheme's MFU
    count (default 1, the paper's configuration)."""
    if scheme == "shared":
        m, f = 1, 1
    elif scheme == "sym_mimd":
        m, f = M, M
    elif scheme == "het_mimd":
        m, f = M, 1 if F is None else F
    else:
        raise ValueError(f"unknown scheme {scheme!r}; valid: {SCHEMES}")
    return KlessydraConfig(name or scheme, M=m, F=f, D=D,
                           spm_kbytes=spm_kbytes,
                           subword_bits=subword_bits,
                           fu_counts=fu_counts, **kw)


@dataclass(frozen=True)
class DesignPoint:
    """One fully-specified coprocessor configuration + workload precision
    + per-point pass toggles — the unit the sweep executes."""

    scheme: str
    M: int
    F: int
    D: int
    precision_bits: int = 32
    spm_kbytes: int = 64
    chaining: bool = False
    fu_counts: Tuple[Tuple[str, int], ...] = ()
    # None -> the backend's default optimizing pipeline; () -> raw
    # programs; a tuple of registered pass names -> custom pipeline.
    passes: Optional[Tuple[str, ...]] = None
    # Opt-in Pallas walltime measurement: the sweep additionally batches
    # this point's programs through PallasBackend.run_workload and
    # records real walltime + compiled pallas_call counts. A measurement
    # mode, not a hardware axis — it does not enter the point's name.
    measure_pallas: bool = False

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"DesignPoint: scheme must be one of "
                             f"{SCHEMES}, got {self.scheme!r}")
        if self.scheme == "shared" and (self.M != 1 or self.F != 1):
            raise ValueError(f"DesignPoint: shared scheme requires "
                             f"M=F=1, got M={self.M} F={self.F}")
        if self.scheme == "sym_mimd" and (self.M < 2 or self.F != self.M):
            raise ValueError(f"DesignPoint: sym_mimd requires F=M>=2, "
                             f"got M={self.M} F={self.F}")
        if self.scheme == "het_mimd" and not (1 <= self.F < self.M):
            raise ValueError(f"DesignPoint: het_mimd requires "
                             f"1 <= F < M, got M={self.M} F={self.F}")
        if self.precision_bits not in _VALID_PRECISIONS:
            raise ValueError(f"DesignPoint: precision_bits must be one "
                             f"of {_VALID_PRECISIONS}, got "
                             f"{self.precision_bits}")
        # config construction validates D / spm_kbytes / fu_counts and
        # raises the field-naming ValueError itself
        self.config()

    @property
    def elem_bytes(self) -> int:
        return self.precision_bits // 8

    @property
    def name(self) -> str:
        n = (f"{self.scheme}_M{self.M}F{self.F}_D{self.D}"
             f"_b{self.precision_bits}_spm{self.spm_kbytes}")
        if self.chaining:
            n += "_chain"
        if self.passes == ():
            n += "_raw"
        elif self.passes is not None:
            n += "_p" + "-".join(self.passes)
        if self.fu_counts:
            n += "_fu" + "-".join(f"{u}{c}" for u, c in self.fu_counts)
        return n

    def canonical_dict(self) -> dict:
        """JSON-native identity of the point for content-addressed
        caching (the reference's ``repro.kvi.dse.pointcache``): every field that can
        change a measurement. ``measure_pallas`` is deliberately
        excluded — it is a measurement *mode* (Pallas results cache
        under their own class key), not a hardware axis — and ``name``
        is derived, so it is excluded too."""
        return {"scheme": self.scheme, "M": self.M, "F": self.F,
                "D": self.D, "precision_bits": self.precision_bits,
                "spm_kbytes": self.spm_kbytes,
                "chaining": bool(self.chaining),
                "fu_counts": [[u, c] for u, c in self.fu_counts],
                "passes": list(self.passes)
                if self.passes is not None else None}

    def config(self) -> KlessydraConfig:
        """The concrete machine: hardware sub-word support matches the
        point's data precision (a 32-bit point carries no sub-word
        lanes; an 8-bit point carries the full splitters)."""
        return scheme_config(self.scheme, D=self.D,
                             spm_kbytes=self.spm_kbytes, M=self.M,
                             F=self.F, subword_bits=self.precision_bits,
                             fu_counts=self.fu_counts, name=self.name)


@dataclass(frozen=True)
class DesignSpace:
    """A declarative grid over design points. Axes are tuples; the
    product (restricted to scheme-consistent combinations) is the swept
    space. Enumeration order is deterministic: axes iterate in declared
    order, nested scheme -> M -> F -> D -> precision -> spm -> chaining
    -> pipeline -> fu_counts."""

    schemes: Tuple[str, ...] = SCHEMES
    lanes: Tuple[int, ...] = (2, 4, 8, 16)            # D axis
    precisions: Tuple[int, ...] = (8, 16, 32)         # sub-word bits
    spm_kbytes: Tuple[int, ...] = (64,)
    chaining: Tuple[bool, ...] = (False,)
    replication: Tuple[int, ...] = (3,)               # M axis (MIMD)
    het_fus: Tuple[int, ...] = (1,)                   # F axis (het only)
    pipelines: Tuple[Optional[Tuple[str, ...]], ...] = (None,)
    fu_counts: Tuple[Tuple[Tuple[str, int], ...], ...] = ((),)

    def __post_init__(self):
        def bad(axis: str, why: str):
            raise ValueError(f"DesignSpace: axis {axis!r} {why}")
        for axis in ("schemes", "lanes", "precisions", "spm_kbytes",
                     "chaining", "replication", "het_fus", "pipelines",
                     "fu_counts"):
            if not getattr(self, axis):
                bad(axis, "must be non-empty")
        for s in self.schemes:
            if s not in SCHEMES:
                bad("schemes", f"contains unknown scheme {s!r} "
                               f"(valid: {SCHEMES})")
        for p in self.precisions:
            if p not in _VALID_PRECISIONS:
                bad("precisions", f"contains {p}; valid: "
                                  f"{_VALID_PRECISIONS}")
        for d in self.lanes:
            if d < 1 or (d & (d - 1)):
                bad("lanes", f"must contain powers of two >= 1 "
                             f"(SPM bank counts), got {d}")
        for s in self.spm_kbytes:
            if s < 1:
                bad("spm_kbytes", f"must be >= 1 KiB, got {s}")
        for m in self.replication:
            if m < 2:
                bad("replication", f"MIMD replication must be >= 2, "
                                   f"got {m}")
        for f in self.het_fus:
            if f < 1:
                bad("het_fus", f"must be >= 1, got {f}")

    def _mf_pairs(self, scheme: str) -> List[Tuple[int, int]]:
        """The scheme-consistent (M, F) combinations of this space."""
        if scheme == "shared":
            return [(1, 1)]
        if scheme == "sym_mimd":
            return [(m, m) for m in self.replication]
        return [(m, f) for m in self.replication
                for f in self.het_fus if f < m]

    def _scheme_fus(self, scheme: str) -> tuple:
        """The fu_counts axis applies to het-MIMD only (see points())."""
        return self.fu_counts if scheme == "het_mimd" else ((),)

    @property
    def grid_size(self) -> int:
        """Number of grid cells WITHOUT enumerating them — the product
        of the per-scheme sub-grids. Equals ``len(self.points())`` when
        the axes carry no duplicate values (points() dedups by name)."""
        inner = (len(self.lanes) * len(self.precisions)
                 * len(self.spm_kbytes) * len(self.chaining)
                 * len(self.pipelines))
        return sum(len(self._mf_pairs(s)) * inner * len(self._scheme_fus(s))
                   for s in self.schemes)

    def point_at(self, index: int) -> DesignPoint:
        """Decode flat ``index`` (mixed-radix over the axes, in exactly
        the :meth:`points` nesting order) into a :class:`DesignPoint` —
        O(1) random access into the grid without materializing it. The
        lazy primitive the reference's ``repro.kvi.dse.search.CandidateSampler``
        draws from: ``space.point_at(rng.randrange(space.grid_size))``
        is a uniform sample of the grid."""
        if index < 0:
            raise IndexError(f"point_at: negative index {index}")
        i = index
        for scheme in self.schemes:
            mf_pairs = self._mf_pairs(scheme)
            fus = self._scheme_fus(scheme)
            block = (len(mf_pairs) * len(self.lanes)
                     * len(self.precisions) * len(self.spm_kbytes)
                     * len(self.chaining) * len(self.pipelines)
                     * len(fus))
            if i >= block:
                i -= block
                continue
            # innermost axis varies fastest, mirroring points() nesting
            i, fu_i = divmod(i, len(fus))
            i, pipe_i = divmod(i, len(self.pipelines))
            i, ch_i = divmod(i, len(self.chaining))
            i, spm_i = divmod(i, len(self.spm_kbytes))
            i, prec_i = divmod(i, len(self.precisions))
            mf_i, d_i = divmod(i, len(self.lanes))
            m, f = mf_pairs[mf_i]
            return DesignPoint(scheme, m, f, self.lanes[d_i],
                               self.precisions[prec_i],
                               self.spm_kbytes[spm_i],
                               self.chaining[ch_i], fus[fu_i],
                               self.pipelines[pipe_i])
        raise IndexError(f"point_at: index {index} out of range for a "
                         f"{self.grid_size}-cell grid")

    def points(self) -> Tuple[DesignPoint, ...]:
        """Deterministic enumeration of all valid design points.
        Scheme-inconsistent combinations (e.g. het F >= M) are skipped;
        the shared scheme collapses the M axis (always M=F=1), and the
        ``fu_counts`` axis applies to het-MIMD only — the simulator
        contends internal FU instances solely in the heterogeneous
        scheme (shared/sym arbitrate whole MFUs), so replicated-unit
        points for the other schemes would pay area for provably
        identical cycles: always dominated, never informative."""
        out: List[DesignPoint] = []
        seen = set()
        for scheme in self.schemes:
            mf_pairs = self._mf_pairs(scheme)
            fus = self._scheme_fus(scheme)
            for m, f in mf_pairs:
                for d in self.lanes:
                    for prec in self.precisions:
                        for spm in self.spm_kbytes:
                            for ch in self.chaining:
                                for pipe in self.pipelines:
                                    for fu in fus:
                                        pt = DesignPoint(
                                            scheme, m, f, d, prec, spm,
                                            ch, fu, pipe)
                                        if pt.name not in seen:
                                            seen.add(pt.name)
                                            out.append(pt)
        return tuple(out)

    @property
    def size(self) -> int:
        return len(self.points())


@dataclass(frozen=True)
class SpaceConstraints:
    """Budget / axis predicates a candidate must satisfy *before* any
    simulation — what turns a grid into a constrained design question
    ("the best config under this area budget"). Every check here is
    closed-form over the analytic cost model, so feasibility of
    thousands of candidates per second is practical; workload-dependent
    checks (SPM fit, measured energy) belong to the search evaluator.

      * ``max_area_luteq`` — hardware area budget (LUT-equivalents,
        :func:`repro_torch.kvi.dse.cost.hardware_cost`),
      * ``max_static_nj_per_cycle`` — static-power budget
        (:func:`repro_torch.kvi.dse.cost.energy_per_cycle_static`),
      * ``schemes`` / ``max_lanes`` / ``precisions`` — axis filters,
      * ``predicate`` — an arbitrary extra ``point -> bool`` (must be a
        deterministic pure function; it enters no cache key).
    """

    max_area_luteq: Optional[float] = None
    max_static_nj_per_cycle: Optional[float] = None
    schemes: Optional[Tuple[str, ...]] = None
    max_lanes: Optional[int] = None
    precisions: Optional[Tuple[int, ...]] = None
    predicate: Optional[Callable[[DesignPoint], bool]] = None

    def reject_reason(self, point: DesignPoint) -> Optional[str]:
        """Why ``point`` is infeasible, or ``None`` when it satisfies
        every constraint. Axis filters run first (no cost-model work);
        the area/energy budgets evaluate the analytic model."""
        if self.schemes is not None and point.scheme not in self.schemes:
            return f"scheme {point.scheme!r} excluded"
        if self.max_lanes is not None and point.D > self.max_lanes:
            return f"D={point.D} exceeds max_lanes={self.max_lanes}"
        if self.precisions is not None \
                and point.precision_bits not in self.precisions:
            return f"precision {point.precision_bits} excluded"
        if self.predicate is not None and not self.predicate(point):
            return "predicate rejected"
        if self.max_area_luteq is not None \
                or self.max_static_nj_per_cycle is not None:
            from repro_torch.kvi.dse.cost import (energy_per_cycle_static,
                                            hardware_cost)
            cfg = point.config()
            if self.max_area_luteq is not None:
                area = hardware_cost(cfg).area_luteq
                if area > self.max_area_luteq:
                    return (f"area {area:.0f} LUTeq exceeds budget "
                            f"{self.max_area_luteq:.0f}")
            if self.max_static_nj_per_cycle is not None:
                nj = energy_per_cycle_static(cfg)
                if nj > self.max_static_nj_per_cycle:
                    return (f"static {nj:.3f} nJ/cycle exceeds budget "
                            f"{self.max_static_nj_per_cycle:.3f}")
        return None

    def feasible(self, point: DesignPoint) -> bool:
        return self.reject_reason(point) is None

    def as_dict(self) -> dict:
        """JSON-native view for search reports (``predicate`` is
        surfaced only as a presence flag — it has no canonical form)."""
        return {"max_area_luteq": self.max_area_luteq,
                "max_static_nj_per_cycle": self.max_static_nj_per_cycle,
                "schemes": list(self.schemes)
                if self.schemes is not None else None,
                "max_lanes": self.max_lanes,
                "precisions": list(self.precisions)
                if self.precisions is not None else None,
                "has_predicate": self.predicate is not None}


def preflight_point(point: DesignPoint, programs: Sequence,
                    trace_cache=None) -> Optional[str]:
    """SPM-capacity feasibility of ``point`` for a set of programs,
    checked in two stages:

    1. the **static** SPM-pressure estimate
       (:func:`repro_torch.kvi.analysis.spm_pressure` — the analyzer's KVI301
       check) rejects over-pressure programs without touching the
       allocator or the trace cache,
    2. programs that pass run through the lowering allocator's
       liveness-based linear scan (the same code path the real
       execution takes), surfacing any residual
       :class:`~repro_torch.kvi.lowering.SpmOverflowError` message.

    The static estimate reuses the allocator's own liveness peak with
    the allocator's exact line rounding, so the two stages agree; the
    second stage exists to warm the :class:`~repro_torch.kvi.lowering.
    TraceCache` (each program lowers timing-only *into the cache*, so
    the execution that follows reuses the exact traces) and as a
    belt-and-braces check that they stay in agreement.

    Returns the rejection reason of the first program that cannot be
    placed, or ``None`` when all fit."""
    from repro_torch.kvi.analysis import spm_pressure
    from repro_torch.kvi.lowering import SpmOverflowError, allocate_vregs
    cfg = point.config()
    for p in programs:
        pressure = spm_pressure(p, cfg)
        if not pressure.fits:
            return (f"static SPM overflow (KVI301): program "
                    f"{p.name!r} peak-live {pressure.peak_live_bytes} B "
                    f"exceeds SPM capacity {pressure.capacity_bytes} B")
        try:
            if trace_cache is not None:
                trace_cache.lower(p, cfg, chaining=point.chaining,
                                  functional=False)
            else:
                allocate_vregs(p, cfg)
        except SpmOverflowError as e:   # pragma: no cover - static
            return str(e)               # estimate should reject first
    return None

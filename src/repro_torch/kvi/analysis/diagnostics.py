"""Typed diagnostics for the KVI static-analysis layer.

Every check in :mod:`repro_torch.kvi.analysis` reports through a
:class:`Diagnostic`: a stable code (``KVI1xx`` structural, ``KVI2xx``
hazard, ``KVI3xx`` resource), a severity, a human message and the
instruction/operand provenance needed to act on it. A
:class:`DiagnosticReport` is the ordered collection one analysis run
produced, renderable as text or JSON and gateable by severity
(``raise_if`` / the CLI's ``--fail-on``).

Codes are API: tests, the pass-pipeline attribution and external
frontends key on them, so a code's meaning never changes — retired
checks retire their code rather than recycling it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class Severity(IntEnum):
    """Ordered so gates can compare (``ERROR > WARNING > INFO``)."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    def __str__(self) -> str:          # "error", not "Severity.ERROR"
        return self.name.lower()


#: the stable code table — code -> (default severity, one-line meaning).
#: Rendered into the README's diagnostic table; keep the two in sync.
CODES: Dict[str, Tuple[Severity, str]] = {
    # structural (KVI1xx)
    "KVI100": (Severity.ERROR, "required operand missing"),
    "KVI101": (Severity.ERROR, "unknown or unclassified opcode"),
    "KVI102": (Severity.ERROR, "degenerate length (instruction, vreg or "
                               "scalar block <= 0)"),
    "KVI103": (Severity.ERROR, "operand references an undeclared vreg or "
                               "memory buffer"),
    "KVI104": (Severity.ERROR, "operand in the wrong space for its "
                               "position (vreg where mem expected or "
                               "vice versa)"),
    "KVI105": (Severity.ERROR, "operand window outside its vreg "
                               "(offset/extent vs. declared length)"),
    "KVI106": (Severity.ERROR, "elem_bytes disagreement between an "
                               "instruction and its operands"),
    "KVI107": (Severity.ERROR, "memory transfer extent inconsistent with "
                               "the buffer's declared length"),
    "KVI108": (Severity.ERROR, "mem_init shape/dtype inconsistent with "
                               "the MemRef declaration"),
    "KVI109": (Severity.WARNING, "vreg elements read before any write "
                                 "(defined zeros, almost always a bug)"),
    "KVI110": (Severity.ERROR, "output buffer never written by any "
                               "kmemstr"),
    "KVI111": (Severity.ERROR, "duplicate vreg or memory buffer name"),
    "KVI112": (Severity.ERROR, "vreg/mem id disagrees with its position "
                               "(id-indexed lookups would alias)"),
    "KVI113": (Severity.WARNING, "nonzero offset on a memory operand "
                                 "(the MFU transfers whole buffers; "
                                 "the offset is silently ignored)"),
    "KVI114": (Severity.ERROR, "invalid elem_bytes (must be 1/2/4)"),
    # hazard (KVI2xx)
    "KVI201": (Severity.ERROR, "fusion region welds a non-element-wise "
                               "item (mem/reduction/kvcp)"),
    "KVI202": (Severity.ERROR, "fusion region mixes vector lengths or "
                               "element widths"),
    "KVI203": (Severity.ERROR, "fusion region violates a window hazard "
                               "(stale read or overlapping write-back)"),
    "KVI204": (Severity.ERROR, "fusion plan item indices invalid "
                               "(out of range, unordered or duplicated)"),
    "KVI210": (Severity.ERROR, "cross-hart write/write race on one "
                               "logical memory buffer (shared scheme)"),
    "KVI211": (Severity.WARNING, "cross-hart read/write sharing of one "
                                 "logical memory buffer"),
    # resource (KVI3xx)
    "KVI301": (Severity.ERROR, "static SPM pressure exceeds capacity "
                               "(predicts SpmOverflowError)"),
    "KVI302": (Severity.ERROR, "workload entry pinned beyond the "
                               "machine's hart count"),
    "KVI303": (Severity.ERROR, "fusion region exceeds its plan's "
                               "slot-file bounds"),
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + severity + provenance.

    ``item`` is the index into ``program.items`` (None for program- or
    workload-level findings); ``subject`` is a stable name (vreg, buffer
    or region) used as the identity key for pass-to-pass attribution —
    item indices shift as passes delete instructions, names do not.
    """

    code: str
    message: str
    program: str
    severity: Optional[Severity] = None
    item: Optional[int] = None
    op: Optional[str] = None
    subject: Optional[str] = None

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered diagnostic code {self.code!r}")
        if self.severity is None:
            object.__setattr__(self, "severity", CODES[self.code][0])

    @property
    def key(self) -> Tuple[str, str, Optional[str]]:
        """Pass-stable identity: (code, program, subject)."""
        return (self.code, self.program, self.subject)

    def render(self) -> str:
        where = self.program
        if self.item is not None:
            where += f" @item {self.item}"
        if self.op:
            where += f" ({self.op})"
        return f"{self.code} {self.severity}: [{where}] {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {"code": self.code, "severity": str(self.severity),
                "program": self.program, "item": self.item,
                "op": self.op, "subject": self.subject,
                "message": self.message}


@dataclass
class DiagnosticReport:
    """The ordered findings of one analysis run."""

    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, code: str, message: str, program: str, *,
            item: Optional[int] = None, op: Optional[str] = None,
            subject: Optional[str] = None,
            severity: Optional[Severity] = None) -> Diagnostic:
        d = Diagnostic(code, message, program, severity, item, op, subject)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "DiagnosticReport") -> "DiagnosticReport":
        self.diagnostics.extend(other.diagnostics)
        return self

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __bool__(self) -> bool:
        return bool(self.diagnostics)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity >= Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        """No error-severity findings (warnings allowed)."""
        return not self.errors

    @property
    def clean(self) -> bool:
        """No findings at all."""
        return not self.diagnostics

    @property
    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def keys(self) -> set:
        return {d.key for d in self.diagnostics}

    def at_least(self, severity: Severity) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= severity]

    def raise_if(self, severity: Severity = Severity.ERROR) -> None:
        """Raise :class:`KviVerificationError` when any finding is at or
        above ``severity``."""
        hits = self.at_least(severity)
        if hits:
            raise KviVerificationError(DiagnosticReport(hits))

    def render_text(self) -> str:
        if not self.diagnostics:
            return "clean: no diagnostics"
        return "\n".join(d.render() for d in self.diagnostics)

    def as_dicts(self) -> List[Dict[str, object]]:
        return [d.as_dict() for d in self.diagnostics]


def merge_reports(reports: Iterable[DiagnosticReport]) -> DiagnosticReport:
    out = DiagnosticReport()
    for r in reports:
        out.extend(r)
    return out


class KviVerificationError(ValueError):
    """A program or workload failed static verification. Carries the
    offending :class:`DiagnosticReport` so callers can inspect codes."""

    def __init__(self, report: DiagnosticReport,
                 context: Optional[str] = None):
        self.report = report
        head = f"{context}: " if context else ""
        n = len(report)
        super().__init__(
            f"{head}static verification failed with {n} "
            f"diagnostic{'s' if n != 1 else ''}:\n" + report.render_text())

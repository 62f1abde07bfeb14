"""Minimal stdlib-only SVG chart writer.

The DSE reports want two figures next to ``dse_report.md`` — speedup-
vs-D curves and the (cycles, area) Pareto front — without pulling
matplotlib into the dependency set. This module draws exactly what
those need: framed axes with ticks, polyline series, scatter markers
and a legend, as a deterministic SVG string (fixed float formatting, no
timestamps) so the artifacts are byte-stable run to run.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

#: series colors (Okabe-Ito, readable on white and colorblind-safe)
PALETTE = ("#0072B2", "#D55E00", "#009E73", "#CC79A7",
           "#E69F00", "#56B4E9", "#000000", "#F0E442")

#: marker shapes cycled alongside the palette
MARKERS = ("circle", "square", "diamond", "triangle")

_W, _H = 640, 400
_ML, _MR, _MT, _MB = 64, 160, 36, 48       # margins (legend lives right)


def _fmt(x: float) -> str:
    return f"{x:.2f}".rstrip("0").rstrip(".")


def _ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    """<= ``n`` round tick positions covering [lo, hi]."""
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(raw))
    step = min(s * mag for s in (1, 2, 5, 10) if s * mag >= raw)
    first = math.ceil(lo / step) * step
    out = []
    t = first
    while t <= hi + 1e-9:
        out.append(round(t, 10))
        t += step
    return out or [lo]


class Chart:
    """One framed x/y chart; add line/scatter series, then render."""

    def __init__(self, title: str, xlabel: str, ylabel: str,
                 log_x: bool = False):
        self.title = title
        self.xlabel = xlabel
        self.ylabel = ylabel
        self.log_x = log_x
        self.series: List[Tuple[str, List[Tuple[float, float]], str]] = []

    def add(self, label: str, points: Sequence[Tuple[float, float]],
            style: str = "line") -> None:
        """``style`` is ``"line"`` (polyline + markers) or
        ``"scatter"`` (markers only)."""
        pts = [(float(x), float(y)) for x, y in points]
        if pts:
            self.series.append((label, sorted(pts), style))

    # -- rendering -----------------------------------------------------
    def _tx(self, x: float) -> float:
        return math.log10(x) if self.log_x else x

    def render(self) -> str:
        if not self.series:
            return (f'<svg xmlns="http://www.w3.org/2000/svg" '
                    f'width="{_W}" height="{_H}">'
                    f'<text x="20" y="30">{self.title}: no data</text>'
                    f'</svg>')
        xs = [self._tx(x) for _, pts, _ in self.series for x, _ in pts]
        ys = [y for _, pts, _ in self.series for _, y in pts]
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        if x1 == x0:
            x0, x1 = x0 - 0.5, x1 + 0.5
        if y1 == y0:
            y0, y1 = y0 - 0.5, y1 + 0.5
        pad_y = 0.06 * (y1 - y0)
        y0, y1 = y0 - pad_y, y1 + pad_y
        pw = _W - _ML - _MR
        ph = _H - _MT - _MB

        def px(x: float) -> float:
            return _ML + pw * (self._tx(x) - x0) / (x1 - x0)

        def py(y: float) -> float:
            return _MT + ph * (1 - (y - y0) / (y1 - y0))

        e: List[str] = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{_W}" '
            f'height="{_H}" viewBox="0 0 {_W} {_H}" '
            f'font-family="sans-serif" font-size="12">',
            f'<rect width="{_W}" height="{_H}" fill="white"/>',
            f'<text x="{_ML}" y="20" font-size="14" '
            f'font-weight="bold">{self.title}</text>',
            f'<rect x="{_ML}" y="{_MT}" width="{pw}" height="{ph}" '
            f'fill="none" stroke="#999"/>',
        ]
        # ticks + grid
        if self.log_x:
            lo_d, hi_d = math.floor(x0), math.ceil(x1)
            xticks = [10 ** d for d in range(lo_d, hi_d + 1)
                      if x0 - 1e-9 <= d <= x1 + 1e-9]
            xticks = xticks or [10 ** x0]
        else:
            xticks = _ticks(x0, x1)
        for t in xticks:
            x = px(t) if not self.log_x else \
                _ML + pw * (math.log10(t) - x0) / (x1 - x0)
            e.append(f'<line x1="{x:.1f}" y1="{_MT}" x2="{x:.1f}" '
                     f'y2="{_MT + ph}" stroke="#eee"/>')
            e.append(f'<text x="{x:.1f}" y="{_MT + ph + 16}" '
                     f'text-anchor="middle">{_fmt(t)}</text>')
        for t in _ticks(y0, y1):
            y = py(t)
            e.append(f'<line x1="{_ML}" y1="{y:.1f}" x2="{_ML + pw}" '
                     f'y2="{y:.1f}" stroke="#eee"/>')
            e.append(f'<text x="{_ML - 6}" y="{y + 4:.1f}" '
                     f'text-anchor="end">{_fmt(t)}</text>')
        e.append(f'<text x="{_ML + pw / 2:.1f}" y="{_H - 10}" '
                 f'text-anchor="middle">{self.xlabel}</text>')
        e.append(f'<text x="16" y="{_MT + ph / 2:.1f}" '
                 f'text-anchor="middle" transform="rotate(-90 16 '
                 f'{_MT + ph / 2:.1f})">{self.ylabel}</text>')

        # series + legend
        for i, (label, pts, style) in enumerate(self.series):
            color = PALETTE[i % len(PALETTE)]
            marker = MARKERS[i % len(MARKERS)]
            if style == "line" and len(pts) > 1:
                path = " ".join(f"{px(x):.1f},{py(y):.1f}"
                                for x, y in pts)
                e.append(f'<polyline points="{path}" fill="none" '
                         f'stroke="{color}" stroke-width="1.8"/>')
            for x, y in pts:
                e.append(_marker(marker, px(x), py(y), color))
            ly = _MT + 14 + 16 * i
            e.append(_marker(marker, _W - _MR + 14, ly - 4, color))
            e.append(f'<text x="{_W - _MR + 26}" y="{ly}">'
                     f'{label}</text>')
        e.append("</svg>")
        return "\n".join(e)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render() + "\n")


def _marker(shape: str, x: float, y: float, color: str,
            r: float = 3.5) -> str:
    if shape == "circle":
        return (f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{r}" '
                f'fill="{color}"/>')
    if shape == "square":
        return (f'<rect x="{x - r:.1f}" y="{y - r:.1f}" '
                f'width="{2 * r:.1f}" height="{2 * r:.1f}" '
                f'fill="{color}"/>')
    if shape == "diamond":
        pts = f"{x:.1f},{y - r - 1:.1f} {x + r + 1:.1f},{y:.1f} " \
              f"{x:.1f},{y + r + 1:.1f} {x - r - 1:.1f},{y:.1f}"
        return f'<polygon points="{pts}" fill="{color}"/>'
    pts = f"{x:.1f},{y - r - 1:.1f} {x + r + 1:.1f},{y + r:.1f} " \
          f"{x - r - 1:.1f},{y + r:.1f}"
    return f'<polygon points="{pts}" fill="{color}"/>'


def line_chart(title: str, xlabel: str, ylabel: str,
               series: Dict[str, Sequence[Tuple[float, float]]],
               log_x: bool = False) -> str:
    """Convenience: one polyline per ``series`` entry."""
    c = Chart(title, xlabel, ylabel, log_x=log_x)
    for label in series:
        c.add(label, series[label], style="line")
    return c.render()


def scatter_chart(title: str, xlabel: str, ylabel: str,
                  series: Dict[str, Sequence[Tuple[float, float]]],
                  front: Optional[Sequence[Tuple[float, float]]] = None,
                  ) -> str:
    """Scatter per series; ``front`` (if given) is additionally drawn
    as a connecting staircase line — the Pareto-front overlay."""
    c = Chart(title, xlabel, ylabel)
    for label in series:
        c.add(label, series[label], style="scatter")
    svg = c.render()
    if front:
        pts = sorted((float(x), float(y)) for x, y in front)
        # re-render with the front as an extra line series drawn first
        c2 = Chart(title, xlabel, ylabel)
        c2.add("pareto front", pts, style="line")
        for label in series:
            c2.add(label, series[label], style="scatter")
        svg = c2.render()
    return svg

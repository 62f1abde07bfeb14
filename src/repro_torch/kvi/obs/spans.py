"""Spans inside the port's LM train step: timed on the device with CUDA
events, stamped on the host with a clock that converts to
``torch.profiler``'s, and recorded into an :class:`~repro_torch.kvi.obs.Obs`
bundle.

The train step (``models.steps.make_train_step``) opens one root span a
call, ``train_step``, with :func:`step`; inside it the program opens
:func:`span` and :func:`phased` spans at its layer boundaries
(``forward``, ``backward``, ``optimizer``, ``block``, ``ssd``,
``selective_scan``, ``attention``), and :func:`bracketed` brackets one
call's backward between two identity ``autograd.Function`` markers: the
marker on the call's outputs opens the span ``<name>`` of phase
``backward`` when the backward reaches it, the marker on its inputs
closes it. The engine runs nodes by sequence number, so the two bracket
the call's own backward nodes.

On and off. A step is traced while an ``Obs`` is activated
(:func:`activate`) or a ``torch.profiler`` session is active when the step
begins; the decision holds for the whole step, so a block's forward and
its recompute agree (markers made in one are made in the other). Off,
every span site costs one attribute check and returns a shared no-op
context: no event, no ``record_function``, no marker node.

Parenting is kept per step, not per thread: with CUDA tensors autograd
runs the backward on its own device thread while the step's thread waits
in ``torch.autograd.grad``, and the spans opened there (the recomputed
blocks, the bracketed backward) nest under the step's open ``backward``
span. A span opened while ``backward`` is open has phase ``recompute``
(:func:`phased`).

Timing. A span records ``time.perf_counter()`` at open and close, a
``torch.profiler.record_function`` range (a profile with CPU activity
shows it on the host lane), and on a CUDA step a pair of timing events on
the current stream. Nothing synchronises while the step runs: a span is
resolved when the collector is read (:func:`collected`, :func:`flush`),
which waits for the events already recorded. ``device_ms`` is the
elapsed time of the span's own pair; its device-lane start is its first
event's offset from the step's first event, placed at that event's host
stamp, which is exact when the stream was idle when the step began. On
the CPU, ops are synchronous and the host times stand in.

Output. A resolved span becomes a complete wall-clock event on the
bundle tracer's ``("train", "host")`` and ``("train", "device")`` tracks
(args: ``span``, ``parent``, ``step`` ids and the span's own args; the
tracer's ``wall_epoch_ns`` converts both to the profiler's clock) and
one observation in each of the histograms ``train.<key>.device_ms`` and
``train.<key>.host_ms`` of its metrics registry, where ``<key>`` is the
span's name and, for a span with a phase, also ``<name>/<phase>``.
:func:`collected` sums those histograms a key. :func:`count` raises a
counter ``train.<name>`` of the same registry in a traced forward.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional

import torch

from repro_torch.kvi.obs import Obs
from repro_torch.kvi.obs.trace import CLOCK_WALL

HOST = ("train", "host")
DEVICE = ("train", "device")
PREFIX = "train."
ROOT = "train_step"
_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` / ``torch.autograd.profiler`` session
    is active (the Python flag, or the C++ profiler's state)."""
    return (torch.autograd.profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled())


class _Span:
    __slots__ = ("step", "name", "args", "id", "parent", "h0", "h1",
                 "e0", "e1", "rf")

    def __init__(self, step: "_Step", name: str, args: dict):
        self.step, self.name, self.args = step, name, args
        self.h1 = self.e0 = self.e1 = None

    # a span is its own context manager
    def __enter__(self):
        self.step.open(self)
        return self

    def __exit__(self, *exc):
        self.step.close(self)
        return False


class _Step:
    """One traced ``train_step`` call: its open spans, innermost last, and
    the spans it has closed."""

    __slots__ = ("id", "cuda", "obs", "open_spans", "done", "root",
                 "_ids")

    def __init__(self, step_id: int, cuda: bool, obs: Obs, ids):
        self.id, self.cuda, self.obs, self._ids = step_id, cuda, obs, ids
        self.open_spans: List[_Span] = []
        self.done: List[_Span] = []
        self.root: Optional[_Span] = None

    def in_backward(self) -> bool:
        return any(s.name == "backward" for s in self.open_spans)

    def open(self, sp: _Span) -> None:
        sp.id = next(self._ids)
        sp.parent = self.open_spans[-1].id if self.open_spans else None
        sp.rf = torch.autograd.profiler.record_function(sp.name)
        sp.rf.__enter__()
        if self.cuda:
            sp.e0 = torch.cuda.Event(enable_timing=True)
            sp.e0.record()
        self.open_spans.append(sp)
        sp.h0 = time.perf_counter()

    def close(self, sp: _Span) -> None:
        sp.h1 = time.perf_counter()
        if self.cuda:
            sp.e1 = torch.cuda.Event(enable_timing=True)
            sp.e1.record()
        sp.rf.__exit__(None, None, None)
        self.open_spans.remove(sp)
        self.done.append(sp)


class SpanCollector:
    """Where the train step's spans go: the activated bundle, else (under
    a profiler session) one of the collector's own, kept until
    :meth:`reset`."""

    def __init__(self):
        self.obs: Optional[Obs] = None      # activated explicitly
        self.current: Optional[_Step] = None    # the traced step running
        self.reset()

    def reset(self) -> None:
        """Forget every span recorded into the collector's own bundle (an
        activated bundle keeps what it holds)."""
        self._own: Optional[Obs] = None
        self._pending: List[_Step] = []
        self._steps = itertools.count(1)
        self._ids = itertools.count(1)

    def bundle(self) -> Optional[Obs]:
        return self.obs if self.obs is not None else self._own

    @contextlib.contextmanager
    def run_step(self, cuda: bool):
        if self.obs is None and self._own is None:
            self._own = Obs.on()
        st = _Step(next(self._steps), cuda, self.bundle(), self._ids)
        st.root = _Span(st, ROOT, {})
        self.current = st
        try:
            with st.root:
                yield st
        finally:
            self.current = None
            st.open_spans.clear()       # a backward that raised
            self._pending.append(st)

    def flush(self) -> None:
        """Resolve the recorded spans into their bundles, waiting for
        each step's last event."""
        for st in self._pending:
            if st.cuda:
                st.root.e1.synchronize()
            _resolve(st)
        self._pending = []


def _resolve(st: _Step) -> None:
    root, tr, reg = st.root, st.obs.tracer, st.obs.metrics
    for sp in st.done:
        host_ms = (sp.h1 - sp.h0) * 1e3
        if st.cuda:
            device_ms = sp.e0.elapsed_time(sp.e1)
            dev0 = root.h0 + root.e0.elapsed_time(sp.e0) / 1e3
        else:
            device_ms, dev0 = host_ms, sp.h0
        args = dict(sp.args, span=sp.id, parent=sp.parent, step=st.id)
        tr.span(HOST, sp.name, round(tr.wall_us_at(sp.h0), 3),
                round(host_ms * 1e3, 3), cat="span", clock=CLOCK_WALL,
                args=args)
        tr.span(DEVICE, sp.name, round(tr.wall_us_at(dev0), 3),
                round(device_ms * 1e3, 3), cat="span", clock=CLOCK_WALL,
                args=args)
        keys = [sp.name]
        if "phase" in sp.args:
            keys.append(f"{sp.name}/{sp.args['phase']}")
        for k in keys:
            reg.histogram(f"{PREFIX}{k}.device_ms").observe(
                round(device_ms, 6))
            reg.histogram(f"{PREFIX}{k}.host_ms").observe(round(host_ms, 6))


#: the process's collector (the train step and the readers share it)
COLLECTOR = SpanCollector()


def step(batch: dict):
    """The root span of one train step, or a no-op context when neither
    an activated bundle nor a profiler session asks for spans. ``batch``
    (the step's inputs) says whether the step runs on a CUDA device."""
    c = COLLECTOR
    if c.obs is None and not _profiling():
        return _NULL
    dev = next(iter(batch.values())).device
    return c.run_step(dev.type == "cuda")


def span(name: str, **args):
    """A span ``name`` inside the traced step (no-op outside one)."""
    st = COLLECTOR.current
    if st is None:
        return _NULL
    return _Span(st, name, args)


def phased(name: str, **args):
    """:func:`span` with arg ``phase``: ``recompute`` when it opens while
    the step's ``backward`` span is open, else ``forward``."""
    st = COLLECTOR.current
    if st is None:
        return _NULL
    args["phase"] = "recompute" if st.in_backward() else "forward"
    return _Span(st, name, args)


def count(name: str, n: int = 1) -> None:
    """Raise the counter ``train.<name>`` of the traced step's bundle by
    ``n`` in the forward (a block that remat runs again under the step's
    ``backward`` counts nothing); a no-op outside a traced step."""
    st = COLLECTOR.current
    if st is None or st.in_backward():
        return
    st.obs.metrics.counter(PREFIX + name).inc(n)


class _Box:
    """What the two markers of one bracketed call share."""

    __slots__ = ("step", "name", "args", "span")

    def __init__(self, st: _Step, name: str, args: dict):
        self.step, self.name, self.args, self.span = st, name, args, None


class _OpensInBackward(torch.autograd.Function):
    """Identity on a call's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        box = ctx.box
        if COLLECTOR.current is box.step:
            box.span = _Span(box.step, box.name,
                             dict(box.args, phase="backward"))
            box.step.open(box.span)
        return (None,) + grads


class _ClosesInBackward(torch.autograd.Function):
    """Identity on a call's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        box = ctx.box
        if box.span is not None and COLLECTOR.current is box.step:
            box.step.close(box.span)
            box.span = None
        return (None,) + grads


def _marked(cls, box, xs: tuple) -> tuple:
    """``xs`` through one marker: the tensors that need a gradient go in,
    the rest pass by."""
    idx = [i for i, x in enumerate(xs)
           if isinstance(x, torch.Tensor) and x.requires_grad]
    if not idx:
        return xs
    out = list(xs)
    for i, y in zip(idx, cls.apply(box, *(xs[i] for i in idx))):
        out[i] = y
    return tuple(out)


def bracketed(name: str, fn, *inputs, span_args: Optional[dict] = None,
              **kw):
    """``fn(*inputs, **kw)`` in a :func:`phased` span ``name`` with the args
    ``span_args``, its backward bracketed as the span ``name`` of phase
    ``backward`` (the same args): from
    the gradient of its output (a tuple's first, the one the loss
    reaches; marking the others would pull their graphs into the
    loss's) to the gradients of its tensor inputs. The markers are made
    only in a traced step, under autograd and on plain tensors (on a
    ``DeviceMesh`` the backward span is left out). Returns ``fn``'s
    result (a tensor or a tuple)."""
    st = COLLECTOR.current
    if st is None:
        return fn(*inputs, **kw)
    args = dict(span_args or {})
    with phased(name, **args):
        mark = torch.is_grad_enabled() and all(
            type(x) is torch.Tensor for x in inputs if x is not None)
        if not mark:
            return fn(*inputs, **kw)
        box = _Box(st, name, args)
        out = fn(*_marked(_ClosesInBackward, box, inputs), **kw)
        if isinstance(out, tuple):
            return _marked(_OpensInBackward, box, out[:1]) + out[1:]
        return _marked(_OpensInBackward, box, (out,))[0]


@contextlib.contextmanager
def activate(obs: Obs):
    """Trace every train step run inside the block into ``obs``."""
    prev, COLLECTOR.obs = COLLECTOR.obs, obs
    try:
        yield obs
    finally:
        COLLECTOR.flush()
        COLLECTOR.obs = prev


def flush() -> None:
    """Resolve every recorded span into its bundle (waits for the
    spans' device events)."""
    COLLECTOR.flush()


def reset() -> None:
    COLLECTOR.reset()


def collected(obs: Optional[Obs] = None) -> Optional[Dict[str, object]]:
    """What ``obs`` (by default the collector's bundle: the activated one,
    else its own) holds, resolved: ``{"steps": number of train_step
    spans, "spans": {key: {"count", "device_ms", "host_ms"}}}`` with
    totals over every step, keyed by span name and ``name/phase``;
    ``None`` when it holds no step."""
    COLLECTOR.flush()
    obs = obs if obs is not None else COLLECTOR.bundle()
    if obs is None:
        return None
    hists = obs.metrics.snapshot()["histograms"]
    spans: Dict[str, Dict[str, float]] = {}
    for name, h in hists.items():
        if not name.startswith(PREFIX):
            continue
        key, _, unit = name[len(PREFIX):].rpartition(".")
        rec = spans.setdefault(key, {"count": h["count"]})
        rec[unit] = h["sum"]
    steps = spans.get(ROOT, {}).get("count", 0)
    if not steps:
        return None
    return {"steps": steps, "spans": spans}

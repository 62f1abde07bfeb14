"""Load generation for the KVI serving engine (the port's copy of
``repro.kvi.serving.load``: the same templates, instances and arrivals
under the same seeds).

A *template* is one request structure the service offers: a kernel
(conv / fft / matmul) at one sub-word precision, built once, optimized
once through the pass pipeline (so every request arrives with its fusion
plan attached and the backend runs ``passes=()``), and profiled once on
the scheduler's estimator machine. A *request* is a data instance of a
template: same instruction stream, fresh input buffers — which is what
lets the engine batch requests by :func:`structural_signature` into one
walk-kernel launch and the
:class:`~repro_torch.kvi.torch_backend.KernelCache` serve steady-state
traffic with zero rebuilt records.

Weights are immediates: the conv filter and (resident) matmul A-matrix
are baked into the instruction stream at template build, exactly the
one-model / N-inputs inference shape — requests randomize only the data
buffers (conv image, fft signal, matmul B). FFT twiddle buffers are
shared constants.

Arrivals come from a Poisson process over *virtual cycles* (thousands of
clients submitting independently aggregate to one Poisson stream) or
from a JSON trace file, both fully deterministic under a seed.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import KlessydraConfig
from repro_torch.kvi.ir import KviProgram
from repro_torch.kvi.lowering import TraceCache
from repro_torch.kvi.scheduler import simulated_profile
from repro_torch.kvi.workload import structural_signature

#: buffers never randomized per request: FFT twiddle tables (wre*/wim*)
#: are part of the kernel, not of a request's data
_CONST_PREFIXES = ("wre", "wim")


@dataclass(frozen=True)
class RequestSpec:
    """One trace row: a request of ``kernel`` at ``elem_bytes`` precision
    arriving at virtual cycle ``t`` from ``client``."""

    t: int
    kernel: str
    elem_bytes: int
    client: int = 0

    @property
    def template_key(self) -> str:
        return template_key(self.kernel, self.elem_bytes)


def template_key(kernel: str, elem_bytes: int) -> str:
    """The (kernel, precision) naming convention: ``conv@32`` etc."""
    return f"{kernel}@{8 * elem_bytes}"


@dataclass
class KernelTemplate:
    """One request structure: an optimized prototype program plus its
    solo-run cost profile. ``instantiate`` mints data instances."""

    name: str                    # template_key(kernel, elem_bytes)
    kernel: str                  # "conv" | "fft" | "matmul"
    elem_bytes: int
    program: KviProgram          # optimized; fusion plan in meta
    data_mems: frozenset         # buffer names randomized per request
    profile: Dict[str, int]     # solo cycles/busy/stall/idle (estimator)
    data_limit: int = 64         # request data drawn from [-limit, limit)

    @property
    def est_cycles(self) -> int:
        return self.profile["cycles"]

    @property
    def signature(self) -> tuple:
        return structural_signature(self.program)

    def instantiate(self, seed: int, rid: int) -> KviProgram:
        """A data instance for request ``rid``: fresh inputs drawn from
        ``(seed, rid)`` — deterministic and independent of the order the
        engine materializes requests in. Structure (items, vregs, mems,
        attached fusion plan) is shared with the prototype, so identity-
        and signature-keyed caches downstream stay warm."""
        rng = np.random.default_rng((seed, rid))
        mem_init = {}
        for m in self.program.mems:
            proto = self.program.mem_init[m.id]
            if m.is_output:
                mem_init[m.id] = np.zeros_like(proto)
            elif m.name in self.data_mems:
                mem_init[m.id] = rng.integers(
                    -self.data_limit, self.data_limit, proto.shape
                ).astype(proto.dtype)
            else:
                mem_init[m.id] = proto            # shared constant
        return self.program.replace(
            name=f"{self.name}#{rid}", mem_init=mem_init)

    def as_dict(self) -> Dict[str, object]:
        return {"name": self.name, "kernel": self.kernel,
                "elem_bytes": self.elem_bytes,
                "n_instructions": self.program.n_instructions,
                "profile": dict(self.profile)}


def _build_program(kernel: str, elem_bytes: int, smoke: bool,
                   seed: int) -> KviProgram:
    from repro_torch.kvi.programs import (conv2d_program, fft_program,
                                    matmul_program)
    S, n_fft, m = (8, 32, 8) if smoke else (16, 64, 16)
    # stable per-kernel stream id (str hash is process-randomized)
    kid = {"conv": 1, "fft": 2, "matmul": 3}.get(kernel, 0)
    rng = np.random.default_rng((seed, kid, elem_bytes))
    lim = {1: 8, 2: 64, 4: 128}[elem_bytes]
    if kernel == "conv":
        img = rng.integers(-lim, lim, (S, S)).astype(np.int32)
        filt = rng.integers(-8, 8, (3, 3)).astype(np.int32)
        return conv2d_program(img, filt, shift=4, elem_bytes=elem_bytes)
    if kernel == "fft":
        re = rng.integers(-lim, lim, n_fft).astype(np.int32)
        im = rng.integers(-lim, lim, n_fft).astype(np.int32)
        return fft_program(re, im, elem_bytes=elem_bytes)
    if kernel == "matmul":
        A = rng.integers(-lim // 2 or 2, lim // 2 or 2, (m, m)
                         ).astype(np.int32)
        B = rng.integers(-lim // 2 or 2, lim // 2 or 2, (m, m)
                         ).astype(np.int32)
        return matmul_program(A, B, shift=2, resident=True,
                              elem_bytes=elem_bytes)
    raise ValueError(f"unknown kernel {kernel!r}; "
                     f"expected conv / fft / matmul")


def make_templates(mix: Sequence[Tuple[str, int]],
                   smoke: bool = True, seed: int = 0,
                   passes=None,
                   est_config: Optional[KlessydraConfig] = None,
                   trace_cache: Optional[TraceCache] = None,
                   ) -> Dict[str, KernelTemplate]:
    """Build, optimize and profile one template per ``(kernel,
    elem_bytes)`` pair of ``mix``. One :class:`TraceCache` threads
    through profiling so the SPM allocator runs once per template."""
    from repro_torch.kvi.passes import PassPipeline
    pipe = PassPipeline.from_spec(passes)
    cache = trace_cache if trace_cache is not None else TraceCache()
    templates: Dict[str, KernelTemplate] = {}
    for kernel, eb in mix:
        key = template_key(kernel, eb)
        if key in templates:
            raise ValueError(f"duplicate template {key!r} in mix")
        prog = _build_program(kernel, eb, smoke, seed)
        if pipe:
            prog = pipe.run(prog)
        data_mems = frozenset(
            m.name for m in prog.mems
            if not m.is_output and not m.name.startswith(_CONST_PREFIXES))
        profile = simulated_profile(prog, est_config, trace_cache=cache)
        lim = {1: 8, 2: 64, 4: 128}[eb]
        templates[key] = KernelTemplate(key, kernel, eb, prog, data_mems,
                                        profile, data_limit=lim)
    return templates


DEFAULT_MIX: Tuple[Tuple[str, int], ...] = (
    ("conv", 4), ("conv", 1), ("fft", 4), ("matmul", 2))

SMOKE_MIX: Tuple[Tuple[str, int], ...] = (
    ("conv", 4), ("matmul", 2))


def poisson_arrivals(templates: Dict[str, KernelTemplate],
                     n_requests: int,
                     mean_interarrival_cycles: float,
                     n_clients: int = 1000,
                     seed: int = 0,
                     weights: Optional[Dict[str, float]] = None,
                     ) -> List[RequestSpec]:
    """A Poisson request stream over virtual cycles: exponential
    inter-arrival gaps at the aggregate rate (the superposition of
    ``n_clients`` independent client processes), template picked per
    request by ``weights`` (uniform over templates by default)."""
    if n_requests <= 0:
        raise ValueError("n_requests must be > 0")
    if mean_interarrival_cycles <= 0:
        raise ValueError("mean_interarrival_cycles must be > 0")
    names = sorted(templates)
    if weights:
        p = np.asarray([float(weights.get(n, 0.0)) for n in names])
        if p.sum() <= 0:
            raise ValueError("weights select no template")
        p = p / p.sum()
    else:
        p = np.full(len(names), 1.0 / len(names))
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival_cycles, n_requests)
    times = np.floor(np.cumsum(gaps)).astype(np.int64)
    picks = rng.choice(len(names), n_requests, p=p)
    clients = rng.integers(0, n_clients, n_requests)
    specs = []
    for t, k, c in zip(times, picks, clients):
        tpl = templates[names[int(k)]]
        specs.append(RequestSpec(int(t), tpl.kernel, tpl.elem_bytes,
                                 int(c)))
    return specs


def save_trace(specs: Sequence[RequestSpec], path: str) -> None:
    """Persist an arrival trace as JSON (the ``--trace`` file format)."""
    with open(path, "w") as f:
        json.dump({"requests": [
            {"t": s.t, "kernel": s.kernel, "elem_bytes": s.elem_bytes,
             "client": s.client} for s in specs]}, f, indent=2)


def load_trace(path: str) -> List[RequestSpec]:
    """Read an arrival trace written by :func:`save_trace` (requests are
    re-sorted by arrival time — the engine requires monotone arrivals)."""
    with open(path) as f:
        data = json.load(f)
    specs = [RequestSpec(int(r["t"]), str(r["kernel"]),
                         int(r["elem_bytes"]), int(r.get("client", 0)))
             for r in data["requests"]]
    return sorted(specs, key=lambda s: s.t)

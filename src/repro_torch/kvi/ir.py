"""Typed KVI program IR — the paper's Table-1 vector ISA, authored once.

A :class:`KviProgram` is a backend-neutral description of a Klessydra-T
vector computation: named virtual vector registers (``VReg``), main-memory
buffers (``MemRef``), and a linear sequence of :class:`KviInstr` /
:class:`ScalarBlock` items. This module is the PyTorch port's copy of the reference IR (``repro.kvi.ir``),
kept field-for-field identical so programs carry across
(:func:`repro_torch.kvi.interop.program_from_reference`). The port's one
registered :class:`~repro_torch.kvi.backend.Backend` is ``torch``:
element-wise subgraphs run as one fused CUDA kernel launch each.

Operands are :class:`Ref` values: (space, id, element offset). A ``View``
is a builder-side convenience — a (register, offset, length) window that
op emitters accept wherever a vector operand is expected.

Sub-word SIMD: every ``VReg`` carries ``elem_bytes`` (4/2/1 for
32/16/8-bit lanes, paper §"sub-word SIMD"); instructions inherit it from
their operands and backends pack lanes accordingly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


class KviOp(Enum):
    """Paper Table 1, verbatim. ``value`` is the assembly mnemonic and the
    key into the reference's ``repro.core.isa.OPDEFS`` timing classes."""

    KMEMLD = "kmemld"
    KMEMSTR = "kmemstr"
    KADDV = "kaddv"
    KSUBV = "ksubv"
    KVMUL = "kvmul"
    KVRED = "kvred"
    KDOTP = "kdotp"
    KSVADDSC = "ksvaddsc"
    KSVADDRF = "ksvaddrf"
    KSVMULSC = "ksvmulsc"
    KSVMULRF = "ksvmulrf"
    KDOTPPS = "kdotpps"
    KSRLV = "ksrlv"
    KSRAV = "ksrav"
    KRELU = "krelu"
    KVSLT = "kvslt"
    KSVSLT = "ksvslt"
    KVCP = "kvcp"


# op classes (drive backend dispatch)
MEM_OPS = frozenset({KviOp.KMEMLD, KviOp.KMEMSTR})
REDUCTION_OPS = frozenset({KviOp.KVRED, KviOp.KDOTP, KviOp.KDOTPPS,
                           KviOp.KSVADDRF, KviOp.KSVMULRF})
ELEMWISE_OPS = frozenset({KviOp.KADDV, KviOp.KSUBV, KviOp.KVMUL,
                          KviOp.KSVADDSC, KviOp.KSVMULSC, KviOp.KSRLV,
                          KviOp.KSRAV, KviOp.KRELU, KviOp.KVSLT,
                          KviOp.KSVSLT, KviOp.KVCP})
TWO_SOURCE_OPS = frozenset({KviOp.KADDV, KviOp.KSUBV, KviOp.KVMUL,
                            KviOp.KVSLT, KviOp.KDOTP, KviOp.KDOTPPS})


@dataclass(frozen=True)
class Ref:
    """One operand reference: a window base inside a vreg or a memory
    buffer handle. ``offset`` is in elements (not bytes)."""

    space: str                       # "vreg" | "mem"
    id: int
    offset: int = 0

    def __post_init__(self):
        if self.space not in ("vreg", "mem"):
            raise ValueError(f"bad operand space {self.space!r}")
        if self.offset < 0:
            raise ValueError(
                f"negative offset {self.offset} in {self.space} operand "
                f"#{self.id}")


@dataclass(frozen=True)
class KviInstr:
    """One KVI instruction over IR operands. Frozen — programs are
    immutable once built, so every backend sees the same trace."""

    op: KviOp
    dst: Optional[Ref] = None
    src1: Optional[Ref] = None
    src2: Optional[Ref] = None
    scalar: int = 0
    length: int = 0
    elem_bytes: int = 4

    def __post_init__(self):
        if not isinstance(self.op, KviOp):
            raise TypeError(f"op must be KviOp, got {self.op!r}")
        if self.length <= 0:
            raise ValueError(f"{self.op.value}: length must be > 0")
        if self.elem_bytes not in (1, 2, 4):
            raise ValueError(f"elem_bytes must be 1/2/4, got {self.elem_bytes}")
        if self.op in TWO_SOURCE_OPS and self.src2 is None:
            raise ValueError(f"{self.op.value} needs two vector sources")


@dataclass(frozen=True)
class ScalarBlock:
    """A compressed run of ``count`` scalar (non-coprocessor) instructions
    — loop bookkeeping, address arithmetic, branches."""

    count: int


Item = Union[KviInstr, ScalarBlock]


class VReg:
    """A named virtual vector register (an SPM-resident vector in the
    hardware model; a column window of the device regfile in the torch backend). Index/slice to get a
    sub-window ``View``."""

    __slots__ = ("name", "id", "length", "elem_bytes")

    def __init__(self, name: str, id: int, length: int, elem_bytes: int = 4):
        if length <= 0:
            raise ValueError(
                f"vreg {name!r}: length must be > 0, got {length}")
        if elem_bytes not in (1, 2, 4):
            raise ValueError(
                f"vreg {name!r}: elem_bytes must be 1/2/4, got {elem_bytes}")
        self.name = name
        self.id = id
        self.length = length
        self.elem_bytes = elem_bytes

    def view(self, offset: int, length: int) -> "View":
        return View(self, offset, length)

    def __getitem__(self, key) -> "View":
        if isinstance(key, slice):
            start, stop, step = key.indices(self.length)
            if step != 1:
                raise IndexError("strided vreg views are not supported")
            return self.view(start, stop - start)
        return self.view(int(key), 1)

    def __len__(self) -> int:
        return self.length

    def __repr__(self):
        return (f"VReg({self.name!r}, id={self.id}, len={self.length}, "
                f"eb={self.elem_bytes})")


class View:
    """A (vreg, offset, length) window — what op emitters consume."""

    __slots__ = ("reg", "offset", "length")

    def __init__(self, reg: VReg, offset: int, length: int):
        if offset < 0:
            raise ValueError(
                f"view of vreg {reg.name!r}: negative offset {offset}")
        if length <= 0:
            raise ValueError(
                f"view of vreg {reg.name!r}: length must be > 0, "
                f"got {length}")
        if offset + length > reg.length:
            raise IndexError(
                f"view [{offset}:{offset + length}) outside vreg "
                f"{reg.name!r} of length {reg.length}")
        self.reg = reg
        self.offset = offset
        self.length = length

    @property
    def ref(self) -> Ref:
        return Ref("vreg", self.reg.id, self.offset)

    @property
    def elem_bytes(self) -> int:
        return self.reg.elem_bytes

    def __len__(self) -> int:
        return self.length

    def __repr__(self):
        return (f"View({self.reg.name!r}[{self.offset}:"
                f"{self.offset + self.length}])")


Vec = Union[VReg, View]


def as_view(v: Vec) -> View:
    if isinstance(v, VReg):
        return View(v, 0, v.length)
    if isinstance(v, View):
        return v
    raise TypeError(f"expected VReg or View, got {type(v).__name__}")


@dataclass(frozen=True)
class MemRef:
    """A main-memory buffer handle. ``is_output`` marks buffers collected
    into :class:`BackendResult.outputs` after execution."""

    name: str
    id: int
    length: int
    elem_bytes: int = 4
    is_output: bool = False


@dataclass(frozen=True)
class KviProgram:
    """An immutable KVI program: the single source of truth every backend
    executes. ``mem_init[m.id]`` holds each buffer's initial contents."""

    name: str
    items: Tuple[Item, ...]
    vregs: Tuple[VReg, ...]
    mems: Tuple[MemRef, ...]
    mem_init: Dict[int, np.ndarray]
    alg_ops: int = 0                 # algorithmic mul+add count (energy denom)
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def n_instructions(self) -> int:
        return sum(i.count if isinstance(i, ScalarBlock) else 1
                   for i in self.items)

    @property
    def outputs(self) -> Tuple[MemRef, ...]:
        return tuple(m for m in self.mems if m.is_output)

    def vreg_by_id(self, rid: int) -> VReg:
        return self.vregs[rid]

    def mem_by_id(self, mid: int) -> MemRef:
        return self.mems[mid]

    def replace(self, **kw) -> "KviProgram":
        """A copy with the given fields swapped — how optimizing passes
        rewrite programs (``mem_init`` is shared, never mutated)."""
        return dataclasses.replace(self, **kw)

    def with_meta(self, **kw) -> "KviProgram":
        """A copy with extra ``meta`` entries (e.g. the fusion plan)."""
        return self.replace(meta={**self.meta, **kw})

    def __repr__(self):
        return (f"KviProgram({self.name!r}, {len(self.items)} items, "
                f"{len(self.vregs)} vregs, {len(self.mems)} mem bufs)")


_NP_DTYPE = {1: np.int8, 2: np.int16, 4: np.int32}


def np_dtype(elem_bytes: int):
    return _NP_DTYPE[elem_bytes]


class KviProgramBuilder:
    """Assembler for :class:`KviProgram`: declare vregs / memory buffers,
    emit instructions through named-op methods, then :meth:`build`.

    One program definition drives every backend::

        b = KviProgramBuilder("saxpy")
        hx = b.mem_in("x", x_np)
        r = b.vreg("v", len(x_np))
        b.kmemld(r, hx)
        b.ksvmulsc(r, r, scalar=3)
        b.krelu(r, r)
        hy = b.mem_out("y", len(x_np))
        b.kmemstr(hy, r)
        prog = b.build()
        get_backend("oracle").run(prog).outputs["y"]
    """

    def __init__(self, name: str):
        self.name = name
        self._vregs: List[VReg] = []
        self._mems: List[MemRef] = []
        self._mem_init: Dict[int, np.ndarray] = {}
        self._items: List[Item] = []

    # ---- declarations ---------------------------------------------------
    def vreg(self, name: str, length: int, elem_bytes: int = 4) -> VReg:
        if any(r.name == name for r in self._vregs):
            raise ValueError(
                f"duplicate vreg name {name!r} in program {self.name!r}")
        r = VReg(name, len(self._vregs), length, elem_bytes)
        self._vregs.append(r)
        return r

    def _mem(self, name: str, arr: np.ndarray, elem_bytes: int,
             is_output: bool) -> MemRef:
        if any(m.name == name for m in self._mems):
            raise ValueError(
                f"duplicate memory buffer name {name!r} in program "
                f"{self.name!r}")
        arr = np.ascontiguousarray(arr)
        m = MemRef(name, len(self._mems), int(arr.size), elem_bytes,
                   is_output)
        self._mems.append(m)
        self._mem_init[m.id] = arr
        return m

    def mem_in(self, name: str, arr: np.ndarray,
               elem_bytes: int = 4) -> MemRef:
        """Declare an input buffer with initial contents ``arr``."""
        return self._mem(name, arr, elem_bytes, is_output=False)

    def mem_out(self, name: str, length: int, elem_bytes: int = 4,
                shape: Optional[Tuple[int, ...]] = None) -> MemRef:
        """Declare an output buffer (zero-initialised, collected into
        ``BackendResult.outputs[name]``)."""
        arr = np.zeros(shape if shape is not None else length,
                       np_dtype(elem_bytes))
        return self._mem(name, arr, elem_bytes, is_output=True)

    # ---- emission -------------------------------------------------------
    def _emit(self, op: KviOp, dst: Optional[Ref], src1: Optional[Ref],
              src2: Optional[Ref], scalar: int, length: int,
              elem_bytes: int) -> KviInstr:
        i = KviInstr(op, dst, src1, src2, int(scalar), int(length),
                     elem_bytes)
        self._items.append(i)
        return i

    def scalar(self, n: int):
        """Account ``n`` scalar (non-coprocessor) instructions."""
        if n > 0:
            self._items.append(ScalarBlock(int(n)))

    def kmemld(self, dst: Vec, mem: MemRef,
               length: Optional[int] = None) -> KviInstr:
        d = as_view(dst)
        if mem.length > len(d):
            # the MFU's kmemld always transfers the whole buffer — a
            # buffer larger than the destination window would silently
            # overrun the adjacent SPM allocation
            raise ValueError(
                f"kmemld: buffer {mem.name!r} ({mem.length} elems) does "
                f"not fit destination window of {len(d)} elems")
        n = length if length is not None else min(len(d), mem.length)
        if n > mem.length or n > len(d):
            # the MFU transfers exactly the whole buffer — a declared
            # length beyond the buffer (or the window) would misstate
            # what the instruction writes to every analysis downstream
            raise ValueError(
                f"kmemld: length {n} exceeds buffer {mem.name!r} "
                f"({mem.length} elems) or destination window "
                f"({len(d)} elems)")
        return self._emit(KviOp.KMEMLD, d.ref, Ref("mem", mem.id), None,
                          0, n, d.elem_bytes)

    def kmemstr(self, mem: MemRef, src: Vec,
                length: Optional[int] = None) -> KviInstr:
        s = as_view(src)
        n = length if length is not None else min(len(s), mem.length)
        return self._emit(KviOp.KMEMSTR, Ref("mem", mem.id), s.ref, None,
                          0, n, s.elem_bytes)

    def _vv(self, op: KviOp, dst: Vec, a: Vec, b: Vec,
            scalar: int = 0) -> KviInstr:
        d, va, vb = as_view(dst), as_view(a), as_view(b)
        if len(va) != len(vb):
            raise ValueError(f"{op.value}: source length mismatch "
                             f"{len(va)} vs {len(vb)}")
        return self._emit(op, d.ref, va.ref, vb.ref, scalar, len(va),
                          va.elem_bytes)

    def _vs(self, op: KviOp, dst: Vec, a: Vec, scalar: int = 0) -> KviInstr:
        d, va = as_view(dst), as_view(a)
        return self._emit(op, d.ref, va.ref, None, scalar, len(va),
                          va.elem_bytes)

    # element-wise
    def kaddv(self, dst: Vec, a: Vec, b: Vec):
        return self._vv(KviOp.KADDV, dst, a, b)

    def ksubv(self, dst: Vec, a: Vec, b: Vec):
        return self._vv(KviOp.KSUBV, dst, a, b)

    def kvmul(self, dst: Vec, a: Vec, b: Vec):
        return self._vv(KviOp.KVMUL, dst, a, b)

    def kvslt(self, dst: Vec, a: Vec, b: Vec):
        return self._vv(KviOp.KVSLT, dst, a, b)

    def ksvaddsc(self, dst: Vec, a: Vec, scalar: int):
        return self._vs(KviOp.KSVADDSC, dst, a, scalar)

    def ksvmulsc(self, dst: Vec, a: Vec, scalar: int):
        return self._vs(KviOp.KSVMULSC, dst, a, scalar)

    def ksrlv(self, dst: Vec, a: Vec, scalar: int):
        return self._vs(KviOp.KSRLV, dst, a, scalar)

    def ksrav(self, dst: Vec, a: Vec, scalar: int):
        return self._vs(KviOp.KSRAV, dst, a, scalar)

    def krelu(self, dst: Vec, a: Vec):
        return self._vs(KviOp.KRELU, dst, a)

    def ksvslt(self, dst: Vec, a: Vec, scalar: int):
        return self._vs(KviOp.KSVSLT, dst, a, scalar)

    def kvcp(self, dst: Vec, a: Vec):
        return self._vs(KviOp.KVCP, dst, a)

    # reductions — dst is a single-element view (the register-file result
    # spilled to its architectural destination)
    def _red(self, op: KviOp, dst: Vec, a: Vec, b: Optional[Vec],
             scalar: int = 0) -> KviInstr:
        d, va = as_view(dst), as_view(a)
        if len(d) != 1:
            raise ValueError(f"{op.value}: reduction dst must be a "
                             f"single-element view, got length {len(d)}")
        vb = as_view(b) if b is not None else None
        if vb is not None and len(vb) != len(va):
            raise ValueError(f"{op.value}: source length mismatch")
        return self._emit(op, d.ref, va.ref,
                          vb.ref if vb is not None else None, scalar,
                          len(va), va.elem_bytes)

    def kvred(self, dst: Vec, a: Vec):
        return self._red(KviOp.KVRED, dst, a, None)

    def kdotp(self, dst: Vec, a: Vec, b: Vec):
        return self._red(KviOp.KDOTP, dst, a, b)

    def kdotpps(self, dst: Vec, a: Vec, b: Vec, shift: int):
        return self._red(KviOp.KDOTPPS, dst, a, b, shift)

    def ksvaddrf(self, dst: Vec, a: Vec, scalar: int):
        return self._red(KviOp.KSVADDRF, dst, a, None, scalar)

    def ksvmulrf(self, dst: Vec, a: Vec, scalar: int):
        return self._red(KviOp.KSVMULRF, dst, a, None, scalar)

    # ---- finish ---------------------------------------------------------
    def build(self, alg_ops: int = 0, **meta) -> KviProgram:
        return KviProgram(self.name, tuple(self._items), tuple(self._vregs),
                          tuple(self._mems),
                          {k: v.copy() for k, v in self._mem_init.items()},
                          alg_ops, dict(meta))

"""Content-addressed persistent point cache: incremental re-sweeps (the
port's copy of ``repro.kvi.dse.pointcache``).

Every sweep invocation used to start cold — all points recomputed (and
every ``--measure-device`` class re-measured) even when nothing changed.
This module makes re-sweeps proportional to the *delta*: each measured
:class:`~repro_torch.kvi.dse.sweep.PointRecord` is stored on disk under a
content-addressed key, and :func:`~repro_torch.kvi.dse.sweep.sweep` consults
the store before dispatching :class:`~repro_torch.kvi.dse.executors.PointJob`
units to any executor, so only points whose inputs actually changed run.

The key (:func:`point_key`) fingerprints everything a record depends on:

  * the :class:`~repro_torch.kvi.dse.space.DesignPoint` canonical dict —
    every hardware axis plus the per-point ``chaining`` toggle,
  * the **optimized** kernel program IR (:func:`program_fingerprint`:
    structure, operands, scalar blocks, ``mem_init`` bytes, and the
    attached fusion-plan metadata — what the backend actually executes),
  * the *resolved* pass-pipeline spec (``None`` resolves to the default
    pipeline's names, so changing ``DEFAULT_PASSES`` invalidates),
  * explicit version tokens for the cost model
    (:data:`repro_torch.kvi.dse.cost.CALIBRATION_VERSION`) and the cyclesim
    timing semantics (:data:`repro_torch.kvi.cyclesim.TIMING_VERSION`) —
    bumped by hand and pinned by tests, **not** source hashes, so
    comment-only edits keep caches warm while semantic changes miss,
  * the composite-protocol flag and the store schema version.

``--measure-device`` class measurements cache under their own key
(:func:`device_class_key`) joined with the ``(precision, passes,
harts)`` measurement class and the backend and device that measured
it, so warm re-sweeps launch nothing on the device.

The store (:class:`PointCache`) is a JSON-lines file under
``~/.cache/klessydra-dse-torch`` (or ``--cache-dir``; a directory of its
own, so the port never reads records the reference wrote): one self-checksummed
entry per line, corrupted or schema-stale lines discarded on load (and
recomputed — never fatal), last write per key wins, and a byte-budget
GC policy that compacts the file dropping oldest entries first.
Workers never touch the store: the sweep driver resolves hits in the
parent process and only dispatches misses, so executor spawn semantics
(and canonical-output byte-identity across serial/thread/process) are
unchanged.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

from repro_torch.kvi.ir import KviProgram, ScalarBlock
from repro_torch.kvi.dse.cost import HardwareCost
from repro_torch.kvi.dse.space import DesignPoint

#: Store layout version: a bump discards every existing entry (the
#: loader skips lines whose version differs). Raise it when the entry
#: format — not the measured semantics — changes.
SCHEMA_VERSION = 1

#: Basename of the JSON-lines store inside the cache directory.
STORE_BASENAME = "dse_point_cache.jsonl"

#: Default store size budget before GC compaction drops oldest entries.
DEFAULT_MAX_BYTES = 256 << 20


def default_cache_dir() -> str:
    """``$XDG_CACHE_HOME/klessydra-dse-torch`` (``~/.cache``
    fallback)."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "klessydra-dse-torch")


def _canonical_dumps(obj) -> str:
    """Deterministic JSON: the byte string checksums and keys hash."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def program_fingerprint(program: KviProgram) -> str:
    """A content hash of one program: structure (items, operands,
    scalar blocks), vreg/mem declarations, initial memory bytes, and
    ``meta`` (the fusion plan rides there and changes cyclesim timing
    under chaining). Two programs with equal fingerprints lower to the
    same traces on the same configuration."""
    h = hashlib.sha256()

    def put(*parts):
        for p in parts:
            h.update(repr(p).encode("utf-8"))
            h.update(b"\x1f")

    put("program", program.name, program.alg_ops)
    for v in program.vregs:
        put("vreg", v.name, v.id, v.length, v.elem_bytes)
    for m in program.mems:
        put("mem", m.name, m.id, m.length, m.elem_bytes, m.is_output)
    for item in program.items:
        if isinstance(item, ScalarBlock):
            put("scalar", item.count)
        else:
            put(item.op.value, item.dst, item.src1, item.src2,
                item.scalar, item.length, item.elem_bytes)
    # meta: frozen dataclasses (FusionPlan et al.) have deterministic,
    # content-only reprs — no ids or addresses
    for k in sorted(program.meta):
        put("meta", k, program.meta[k])
    for mid in sorted(program.mem_init):
        arr = program.mem_init[mid]
        put("mem_init", mid, str(arr.dtype), arr.shape)
        h.update(arr.tobytes())
    return h.hexdigest()


def resolved_passes(passes) -> list:
    """The pass names a point's spec actually runs: ``None`` resolves
    to the default pipeline, so a changed ``DEFAULT_PASSES`` changes
    every default-pipeline key."""
    from repro_torch.kvi.passes.pipeline import PassPipeline
    return list(PassPipeline.from_spec(passes).names)


def _version_tokens() -> Dict[str, object]:
    # read through the modules (not from-imports) so test monkeypatching
    # of the tokens is visible to key computation
    from repro_torch.kvi import cyclesim
    from repro_torch.kvi.dse import cost
    return {"schema": SCHEMA_VERSION,
            "calibration": cost.CALIBRATION_VERSION,
            "cyclesim_timing": cyclesim.TIMING_VERSION}


def point_key_components(point: DesignPoint,
                         program_fps: Dict[str, str],
                         composite: bool) -> Dict[str, object]:
    """The key's anatomy, exposed for debugging and the README — what
    :func:`point_key` hashes."""
    comp = _version_tokens()
    comp.update({
        "kind": "point",
        "point": point.canonical_dict(),
        "passes": resolved_passes(point.passes),
        "programs": dict(sorted(program_fps.items())),
        "composite": bool(composite),
    })
    return comp


def point_key(point: DesignPoint, program_fps: Dict[str, str],
              composite: bool) -> str:
    """The content address of one (point, optimized kernels) record.

    ``program_fps`` maps kernel name -> :func:`program_fingerprint` of
    the **optimized** program the point executes — so both the raw
    kernel inputs and the behavior of every active pass are covered."""
    return _sha(_canonical_dumps(
        point_key_components(point, program_fps, composite)))


def device_class_key(program_fps: Dict[str, str], precision_bits: int,
                     passes, harts: int, composite: bool, backend: str,
                     device_name: str) -> str:
    """Content address of one device walltime measurement class.
    Device execution is scheme/D/SPM-blind, so the class — not the
    point — is the cacheable unit: ``(precision, resolved passes,
    harts)`` over the same programs, on one backend (``"torch"``) and
    one device (``torch.cuda.get_device_name``, or ``"cpu"``): a class
    measured on one card never resolves on another card or on the
    CPU."""
    comp = _version_tokens()
    comp.update({
        "kind": "device",
        "backend": str(backend),
        "device_name": str(device_name),
        "precision_bits": int(precision_bits),
        "passes": resolved_passes(passes),
        "harts": int(harts),
        "composite": bool(composite),
        "programs": dict(sorted(program_fps.items())),
    })
    return _sha(_canonical_dumps(comp))


# ---------------------------------------------------------------------------
# Record (de)serialization
# ---------------------------------------------------------------------------


def record_to_payload(rec) -> Dict[str, object]:
    """A :class:`~repro_torch.kvi.dse.sweep.PointRecord` as a JSON-native
    payload. Floats are stored full-precision (JSON round-trips them
    exactly), so a reloaded record re-serializes byte-identically —
    the cold-vs-warm canonical-JSON guarantee rests on this."""
    p: Dict[str, object] = {"point": rec.point.canonical_dict(),
                            "status": rec.status}
    if rec.reason is not None:
        p["reason"] = rec.reason
    if rec.area is not None:
        a = rec.area
        p["area"] = {"luts": a.luts, "ffs": a.ffs, "dsps": a.dsps,
                     "brams": a.brams, "breakdown": dict(a.breakdown)}
    p["kernels"] = rec.kernels
    if rec.composite is not None:
        p["composite"] = rec.composite
    if rec.lowering is not None:
        p["lowering"] = dict(rec.lowering)
    return p


def record_from_payload(payload: Dict[str, object], point: DesignPoint):
    """Rebuild a :class:`PointRecord` from a stored payload. ``point``
    is the *live* design point of the current sweep (key-equal to the
    stored one by construction; volatile flags like ``measure_device``
    may differ, which is why the live object is used)."""
    from repro_torch.kvi.dse.sweep import PointRecord
    area = payload.get("area")
    return PointRecord(
        point=point, status=payload["status"],
        reason=payload.get("reason"),
        area=HardwareCost(
            luts=area["luts"], ffs=area["ffs"], dsps=area["dsps"],
            brams=area["brams"], breakdown=dict(area["breakdown"]))
        if area is not None else None,
        kernels=payload.get("kernels") or {},
        composite=payload.get("composite"),
        wall_s=0.0,
        lowering=payload.get("lowering"),
        cached=True)


# ---------------------------------------------------------------------------
# The on-disk store
# ---------------------------------------------------------------------------


class PointCache:
    """Content-addressed persistent store of sweep measurements.

    One JSON-lines file; each line::

        {"v": 1, "kind": "point"|"device", "key": <sha256>,
         "label": <human identity>, "sha": <payload checksum>,
         "payload": {...}}

    Lookups and stores happen only in the sweep's parent process.
    ``label`` is the *identity* of what the entry measures (point name
    or device class) independent of content: a miss whose label is
    present under a different key is counted as an **invalidation** —
    the same point measured under changed inputs — and the subsequent
    store replaces the stale entry. Corrupted or schema-stale lines are
    discarded on load and recomputed, never fatal. When the file grows
    past ``max_bytes`` it is compacted (duplicates collapse, oldest
    entries drop first)."""

    def __init__(self, cache_dir: Optional[str] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.cache_dir = cache_dir or default_cache_dir()
        self.path = os.path.join(self.cache_dir, STORE_BASENAME)
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.device_hits = 0
        self.device_misses = 0
        self.stores = 0
        self.corrupt_discarded = 0
        self._entries: Optional[Dict[str, Dict[str, object]]] = None
        self._labels: Dict[tuple, str] = {}
        self._rounds: list = []
        self._round_base: Optional[Dict[str, int]] = None

    # -- round accounting -------------------------------------------------

    _COUNTERS = ("hits", "misses", "invalidations", "device_hits",
                 "device_misses", "stores", "corrupt_discarded")

    def _counter_snapshot(self) -> Dict[str, int]:
        return {c: getattr(self, c) for c in self._COUNTERS}

    def _close_round(self) -> None:
        if self._round_base is None:
            return
        snap = self._counter_snapshot()
        self._rounds[-1].update(
            {c: snap[c] - self._round_base[c] for c in self._COUNTERS})
        self._round_base = None

    def begin_round(self, label: str) -> None:
        """Open a named accounting round: counter deltas from here to
        the next ``begin_round`` (or a ``stats`` read) are attributed to
        ``label`` in :attr:`rounds`. Multi-round drivers (the search
        tuner's successive-halving rungs) use this to show *which* rung
        the cache paid off in — lifetime counters alone can't."""
        self._close_round()
        self._rounds.append({"label": str(label)})
        self._round_base = self._counter_snapshot()

    @property
    def rounds(self) -> list:
        """Per-round counter deltas: ``[{"label", "hits", ...}, ...]``.
        The open round (if any) is closed by the read."""
        self._close_round()
        return [dict(r) for r in self._rounds]

    # -- loading ----------------------------------------------------------

    def _load(self) -> Dict[str, Dict[str, object]]:
        if self._entries is not None:
            return self._entries
        self._entries = {}
        try:
            f = open(self.path, "r", encoding="utf-8")
        except OSError:
            return self._entries
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                    if entry["v"] != SCHEMA_VERSION:
                        raise ValueError("schema version mismatch")
                    payload = entry["payload"]
                    if entry["sha"] != _sha(_canonical_dumps(payload)):
                        raise ValueError("payload checksum mismatch")
                    key, kind = entry["key"], entry["kind"]
                    label = entry["label"]
                except (ValueError, KeyError, TypeError):
                    self.corrupt_discarded += 1
                    continue
                self._entries[key] = {"kind": kind, "label": label,
                                      "payload": payload}
                self._labels[(kind, label)] = key
        return self._entries

    # -- lookup / store ---------------------------------------------------

    def _lookup(self, kind: str, key: str,
                label: str) -> Optional[Dict[str, object]]:
        entries = self._load()
        entry = entries.get(key)
        if entry is not None and entry["kind"] == kind:
            # deep copy: callers may attach device columns to record
            # dicts in place — the stored entry must stay pristine
            return json.loads(_canonical_dumps(entry["payload"]))
        if self._labels.get((kind, label), key) != key:
            self.invalidations += 1
        return None

    def _store(self, kind: str, key: str, label: str,
               payload: Dict[str, object]) -> None:
        entries = self._load()
        blob = _canonical_dumps(payload)
        entries[key] = {"kind": kind, "label": label,
                        "payload": json.loads(blob)}
        stale = self._labels.get((kind, label))
        if stale is not None and stale != key:
            entries.pop(stale, None)
        self._labels[(kind, label)] = key
        line = json.dumps({"v": SCHEMA_VERSION, "kind": kind, "key": key,
                           "label": label, "sha": _sha(blob),
                           "payload": json.loads(blob)},
                          sort_keys=True)
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
        self.stores += 1
        try:
            oversized = os.path.getsize(self.path) > self.max_bytes
        except OSError:
            oversized = False
        if oversized:
            self.compact()

    def lookup_point(self, key: str, point: DesignPoint):
        """The cached :class:`PointRecord` for ``key``, or ``None``.
        Hit/miss/invalidation counters update as a side effect."""
        payload = self._lookup("point", key, point.name)
        if payload is None:
            self.misses += 1
            return None
        self.hits += 1
        return record_from_payload(payload, point)

    def store_point(self, key: str, point: DesignPoint, record) -> None:
        self._store("point", key, point.name, record_to_payload(record))

    def lookup_device(self, key: str,
                      label: str) -> Optional[Dict[str, object]]:
        """The cached device class measurement payload, or ``None`` —
        a hit means the warm sweep launches nothing for this class."""
        payload = self._lookup("device", key, label)
        if payload is None:
            self.device_misses += 1
            return None
        self.device_hits += 1
        return payload

    def store_device(self, key: str, label: str,
                     payload: Dict[str, object]) -> None:
        self._store("device", key, label, payload)

    # -- maintenance ------------------------------------------------------

    def compact(self) -> None:
        """Rewrite the store keeping one line per key (last write wins)
        and, if still over ``max_bytes``, dropping oldest entries first.
        Atomic via temp-file + rename."""
        entries = self._load()
        lines = []
        for key, entry in entries.items():      # dict order: oldest first
            blob = _canonical_dumps(entry["payload"])
            lines.append((key, json.dumps(
                {"v": SCHEMA_VERSION, "kind": entry["kind"], "key": key,
                 "label": entry["label"], "sha": _sha(blob),
                 "payload": entry["payload"]}, sort_keys=True) + "\n"))
        total = sum(len(line.encode("utf-8")) for _, line in lines)
        while lines and total > self.max_bytes:
            key, line = lines.pop(0)
            total -= len(line.encode("utf-8"))
            dropped = entries.pop(key)
            self._labels.pop((dropped["kind"], dropped["label"]), None)
        os.makedirs(self.cache_dir, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for _, line in lines:
                f.write(line)
        os.replace(tmp, self.path)

    @property
    def n_entries(self) -> int:
        return len(self._load())

    @property
    def store_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    @property
    def stats(self) -> Dict[str, object]:
        """This run's counters plus store shape — what lands in sweep
        meta (``meta["point_cache"]``, scrubbed from canonical JSON)
        and in ``dse_cache_stats.json``."""
        out: Dict[str, object] = {
            "hits": self.hits, "misses": self.misses,
            "invalidations": self.invalidations,
            "device_hits": self.device_hits,
            "device_misses": self.device_misses,
            "stores": self.stores,
            "corrupt_discarded": self.corrupt_discarded,
            "entries": self.n_entries,
            "store_bytes": self.store_bytes,
            "path": self.path}
        if self._rounds:
            out["rounds"] = self.rounds
        return out

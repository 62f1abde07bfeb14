"""Event-driven cycle simulator of the Klessydra-T13 IMT core + coprocessor
(the port's copy of ``repro.core.simulator``: the optimized event loop).

Microarchitecture model (paper §"THE KLESSYDRA-T IMT ARCHITECTURE"):
  * 3 harts, pure IMT: hart h owns issue slots at cycles ≡ h (mod harts);
    the feed-forward pipeline sustains 1 instruction/cycle aggregate with no
    hazard hardware (the 3-hart rotation is the register-file access fence).
  * Scalar instructions retire 1 per owned slot.
  * Coprocessor instructions occupy their engine: MFU vector ops for
    setup + ceil(len/(D*subword)) cycles; LSU transfers for
    setup_mem + ceil(bytes/4) cycles (single 32-bit memory port, shared).
  * A hart's coprocessor ops execute in program order (SPM consistency);
    scalar work overlaps freely (paper: "The LSU works in parallel with
    other units"; "parallel execution may occur between coprocessor and
    non-coprocessor instructions").
  * Contention by scheme:
      shared (M=1,F=1):  one MFU — any busy vector op blocks all harts
                         ("a hart requesting access to the busy MFU executes
                         a self-referencing jump until the MFU becomes free")
      sym-MIMD (M=F=3):  per-hart MFU/SPM — no inter-hart contention
      het-MIMD (M=3,F=1): per-hart SPMI, shared MFU contended per INTERNAL
                         unit (adder/multiplier/shifter/cmp/move)

Event-driven: O(#instructions), not O(#cycles); validated invariants in
tests (e.g. sym-MIMD cycles <= het-MIMD cycles <= shared cycles).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.configs.base import KlessydraConfig
from repro_torch.core.isa import Instr, Scalar, lsu_cycles, mfu_cycles

Item = Union[Instr, Scalar]


@dataclass
class HartStats:
    instructions: int = 0
    vector_ops: int = 0
    lsu_ops: int = 0
    spin_cycles: int = 0
    finish_cycle: int = 0
    # cycle breakdown over the whole simulated window [0, total):
    #   busy  — the hart is doing something (a coprocessor op of its own
    #           is executing, or it is retiring a scalar issue slot),
    #   stall — waiting to issue a coprocessor op (busy resource, slot
    #           alignment) with nothing of its own in flight,
    #   idle  — the remainder (finished early / unowned slots).
    # Invariant: busy + stall + idle == total cycles (asserted in tests).
    busy_cycles: int = 0
    stall_cycles: int = 0
    idle_cycles: int = 0

    @property
    def total_cycles(self) -> int:
        return self.busy_cycles + self.stall_cycles + self.idle_cycles

    @property
    def utilization(self) -> float:
        return self.busy_cycles / max(self.total_cycles, 1)

    def breakdown(self) -> Dict[str, int]:
        return {"busy": self.busy_cycles, "stall": self.stall_cycles,
                "idle": self.idle_cycles, "total": self.total_cycles}


@dataclass
class SimRecorder:
    """Optional per-event capture for one :meth:`Simulator.run` call —
    the raw material cycle-accurate timeline traces are built from
    (:mod:`repro_torch.kvi.obs`). Recording is opt-in: with
    ``recorder=None`` (the default everywhere) the simulator's inner loop
    executes the exact uninstrumented path, so the disabled overhead is a
    handful of ``is not None`` branches (pinned < 2% by tests).

    All intervals are half-open ``[start, end)`` in simulated cycles:

      instrs  — (hart, op name, engine, start, end, chained) per
                coprocessor instruction's occupancy,
      scalars — (hart, start, end, count) per scalar block,
      waits   — (hart, op name, start, end) per issue stall (the hart
                wanted to issue ``op`` at ``start`` but could not until
                ``end`` — resource busy or slot alignment),
      holds   — (resource key, start, end) per resource acquisition
                (SPMI streams, LSU port, and the per-internal-unit FU
                instances het-MIMD harts contend on).
    """

    instrs: List[tuple] = field(default_factory=list)
    scalars: List[tuple] = field(default_factory=list)
    waits: List[tuple] = field(default_factory=list)
    holds: List[tuple] = field(default_factory=list)


@dataclass
class SimResult:
    cycles: int
    per_hart: List[HartStats]
    mfu_busy_cycles: float
    lsu_busy_cycles: float
    config: KlessydraConfig

    @property
    def mfu_utilization(self) -> float:
        return self.mfu_busy_cycles / max(self.cycles, 1)

    @property
    def hart_utilization(self) -> List[float]:
        """Per-hart busy fraction of the whole workload window."""
        return [h.utilization for h in self.per_hart]


def _merge_intervals(intervals: List[tuple]) -> List[tuple]:
    """Sorted union of half-open [s, e) intervals."""
    out: List[tuple] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _length_outside(intervals: List[tuple], cover: List[tuple]) -> int:
    """Total length of ``intervals`` (a merged list) not overlapped by
    ``cover`` (another merged list)."""
    total = 0
    ci = 0
    for s, e in intervals:
        cur = s
        while cur < e:
            while ci < len(cover) and cover[ci][1] <= cur:
                ci += 1
            if ci == len(cover) or cover[ci][0] >= e:
                total += e - cur
                break
            cs, ce = cover[ci]
            if cs > cur:
                total += cs - cur
            cur = max(cur, min(ce, e))
    return total


def _uncovered_slots(runs: List[tuple], cover: List[tuple],
                     period: int) -> int:
    """Number of 1-cycle slots ``[s + k*period, s + k*period + 1)``,
    ``k < n`` for each run ``(s, n)``, not covered by the merged
    disjoint intervals in ``cover``. Runs must be sorted by start
    (they are appended in issue order). Cycle bounds are integers, so
    a slot is either fully inside one cover interval or fully outside
    all of them — coverage per (run, interval) pair is a closed-form
    count, never a per-slot walk."""
    total = 0
    ci = 0
    n_cover = len(cover)
    for s, n in runs:
        last = s + (n - 1) * period
        while ci < n_cover and cover[ci][1] <= s:
            ci += 1
        covered = 0
        j = ci
        while j < n_cover and cover[j][0] <= last:
            a, b = cover[j]
            klo = -((s - a) // period)        # ceil((a - s) / period)
            if klo < 0:
                klo = 0
            khi = (b - 1 - s) // period
            if khi > n - 1:
                khi = n - 1
            if khi >= klo:
                covered += khi - klo + 1
            j += 1
        total += n - covered
    return total


class Simulator:
    """Cycle simulation of one workload: programs[h] = instruction list for
    hart h. Instruction lists mix Instr (coprocessor) and Scalar(n) items."""

    def __init__(self, config: KlessydraConfig):
        self.cfg = config

    def _resource_holds(self, hart: int, instr: Instr):
        """[(candidate_keys, duration)] an op must acquire — one key per
        equivalent resource instance (the op takes whichever frees first).
        Two resources per MFU op: the SPMI stream (2 passes for 2-source
        ops) and the functional unit (line-rate). Sharing depends on the
        scheme; ``fu_counts`` replicates internal units of the shared MFU
        in the heterogeneous scheme."""
        cfg = self.cfg
        if instr.engine == "lsu":
            dur = lsu_cycles(instr, cfg.mem_port_bytes,
                             cfg.vector_setup_cycles + cfg.mem_latency_cycles)
            # single memory port; the bank interleaver routes the transfer
            # through the SPMI, so it contends with MFU streaming there
            spmi = ("spmi", 0) if cfg.M == 1 else ("spmi", hart)
            return [((("lsu", 0),), dur), ((spmi,), dur)]
        unit_c, spmi_c = mfu_cycles(instr, cfg.D, cfg.vector_setup_cycles,
                                    min_elem_bytes=cfg.subword_bits // 8)
        # FU chaining (repro_torch.kvi.lowering, chaining=True): an op fed
        # directly by the previous op's result stream skips its startup
        # latency; plain traces carry no discount and are untouched
        disc = getattr(instr, "chain_discount", 0)
        if disc:
            unit_c = max(1, unit_c - disc)
            spmi_c = max(1, spmi_c - disc)
        if cfg.M == 1 and cfg.F == 1:
            # shared: one SPMI + one MFU for everyone; SPMI streaming binds
            return [((("spmi", 0),), spmi_c), ((("unit", 0),), unit_c)]
        if cfg.F == cfg.M and cfg.F > 1:
            # symmetric MIMD: per-hart SPMI + per-hart MFU
            return [((("spmi", hart),), spmi_c),
                    ((("unit", hart),), unit_c)]
        # heterogeneous MIMD: per-hart SPMI, F shared MFUs contended per
        # internal unit — the instance pool is F MFUs x fu_count per
        # unit (fu_counts > 1 replicates a unit inside each MFU)
        uname = instr.unit.value
        units = tuple(("unit", uname, k)
                      for k in range(cfg.F * cfg.fu_count(uname)))
        return [((("spmi", hart),), spmi_c), (units, unit_c)]

    def run(self, programs: Sequence[Sequence[Item]],
            recorder: Optional[SimRecorder] = None) -> SimResult:
        """The event loop (the reference's optimized ``Simulator.run``;
        the port's tests hold it to the reference cycle for cycle). Its
        wins over a straight-line loop are structural, not behavioral:

          * resource-hold lists are precomputed once per (hart, item)
            — the candidate scan used to rebuild them (tuples, cycle
            math, ``getattr``) for every hart's head instruction on
            every loop iteration, O(N*H) reconstructions for N items;
          * scalar blocks record one ``(start, count)`` run instead of
            ``count`` 1-cycle interval tuples — the busy accounting
            counts covered slots arithmetically per merged coprocessor
            interval. (A hart's scalar slots can overlap only its own
            in-flight coprocessor op, never its wait intervals: waits
            and scalar slots both live inside the hart's disjoint
            per-item issue windows, so dropping scalar slots from the
            stall cover is exact.)
          * the slot-alignment and dict lookups are inlined/hoisted in
            the scan, the hottest code in every DSE confirmation.
        """
        cfg = self.cfg
        rec = recorder
        H = cfg.harts
        assert len(programs) <= H, "more programs than harts"
        busy_until: Dict[tuple, int] = {}
        bu_get = busy_until.get
        mfu_busy = 0
        lsu_busy = 0
        stats = [HartStats() for _ in range(H)]

        progs = [programs[h] if h < len(programs) else []
                 for h in range(H)]
        lens = [len(p) for p in progs]
        # dispatch fields depend only on (hart, instr), never on time:
        # None marks a Scalar block, otherwise the op's hold list
        prepared = [[None if isinstance(it, Scalar)
                     else self._resource_holds(h, it)
                     for it in progs[h]] for h in range(H)]

        next_slot = list(range(H))
        copro_ready = [0] * H
        pcs = [0] * H
        finish = [0] * H

        activity: List[List[tuple]] = [[] for _ in range(H)]
        scalar_runs: List[List[tuple]] = [[] for _ in range(H)]
        waits: List[List[tuple]] = [[] for _ in range(H)]

        remaining = sum(lens)
        while remaining > 0:
            best_h, best_t = -1, None
            for h in range(H):
                pc = pcs[h]
                if pc >= lens[h]:
                    continue
                t = next_slot[h]
                holds = prepared[h][pc]
                if holds is not None:
                    if copro_ready[h] > t:
                        t = copro_ready[h]
                    for keys, _dur in holds:
                        if len(keys) == 1:
                            avail = bu_get(keys[0], 0)
                        else:
                            avail = min(bu_get(k, 0) for k in keys)
                        if avail > t:
                            t = avail
                    r = (t - h) % H
                    if r:
                        t += H - r
                if best_t is None or t < best_t:
                    best_h, best_t = h, t
            h, t = best_h, best_t
            pc = pcs[h]
            it = progs[h][pc]
            holds = prepared[h][pc]
            st = stats[h]

            if holds is None:
                n = it.count
                end = t + (n - 1) * H + 1 if n else t
                st.instructions += n
                if n:
                    scalar_runs[h].append((t, n))
                    if rec is not None:
                        rec.scalars.append((h, t, end, n))
            else:
                st.instructions += 1
                ns = next_slot[h]
                if t > ns:
                    st.spin_cycles += t - ns
                    waits[h].append((ns, t))
                end = t
                for keys, dur in holds:
                    if len(keys) == 1:
                        k = keys[0]
                    else:
                        k = min(keys, key=lambda kk: bu_get(kk, 0))
                    busy_until[k] = t + dur
                    if t + dur > end:
                        end = t + dur
                    if rec is not None:
                        rec.holds.append((k, t, t + dur))
                if rec is not None:
                    if t > ns:
                        rec.waits.append((h, it.op, ns, t))
                    rec.instrs.append(
                        (h, it.op, it.engine, t, end,
                         getattr(it, "chain_discount", 0) > 0))
                if it.engine == "lsu":
                    st.lsu_ops += 1
                    lsu_busy += end - t
                else:
                    st.vector_ops += 1
                    mfu_busy += end - t
                copro_ready[h] = end
                activity[h].append((t, end))
                end = t + 1                  # issue slot, not occupancy
            r = (end - h) % H
            next_slot[h] = end if r == 0 else end + (H - r)
            if finish[h] < max(end, copro_ready[h]):
                finish[h] = max(end, copro_ready[h])
            pcs[h] += 1
            remaining -= 1

        total = max(finish) if finish else 0
        for h in range(H):
            stats[h].finish_cycle = finish[h]
            cover = _merge_intervals(activity[h])
            busy = sum(e - s for s, e in cover)
            busy += _uncovered_slots(scalar_runs[h], cover, H)
            stall = _length_outside(_merge_intervals(waits[h]), cover)
            stats[h].busy_cycles = busy
            stats[h].stall_cycles = stall
            stats[h].idle_cycles = total - busy - stall
        return SimResult(total, stats, mfu_busy, lsu_busy, cfg)


def simulate(config: KlessydraConfig,
             programs: Sequence[Sequence[Item]],
             recorder: Optional[SimRecorder] = None) -> SimResult:
    return Simulator(config).run(programs, recorder=recorder)

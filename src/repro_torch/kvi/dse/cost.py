"""Analytic hardware cost / energy model for one design point (the
port's copy of ``repro.kvi.dse.cost``; Table 3 is copied below).

FPGA-resource flavored (LUT / FF / DSP / BRAM, the paper synthesizes on
a Xilinx Kintex-7), aggregated into one LUT-equivalent area scalar for
Pareto analysis. The model is *relative*, not sign-off: the calibration
constants below are chosen so the orderings the paper's synthesis tables
establish hold —

  * shared (M=1,F=1) is the cheapest scheme, symmetric MIMD (M=F=3) the
    most expensive, heterogeneous MIMD (M=3,F=1) strictly between: SPMI
    replication is cheaper than MFU replication;
  * area grows with lane count D in every scheme (datapath + bank
    interleaver width);
  * sub-word SIMD support (subword_bits < 32) costs extra lane logic
    (splitters, carry breaks, per-subword predication), so an 8-bit
    design point pays area for its cycle advantage;
  * energy-per-cycle at the operating point lands in the few-nJ range
    of the paper's Table 3 (e.g. Sym MIMD D=8, 12k cycles, 29 uJ ->
    ~2.4 nJ/cycle), with static power proportional to area — so faster
    execution saves energy, the paper's ">85% energy saving" mechanism.

Every constant lives in :data:`CALIBRATION` — one documented table, the
single knob future synthesis-data calibration should touch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import MFU_UNITS, KlessydraConfig

#: Version token of the cost model, part of every persistent sweep
#: cache key (:mod:`repro_torch.kvi.dse.pointcache`). Bump it whenever a
#: :data:`CALIBRATION` constant or the area/energy formulas change in a
#: way that alters any number a :class:`PointRecord` carries — cached
#: records keyed to the old token then miss instead of serving stale
#: areas/energies. Deliberately explicit (not a source hash): comment
#: or refactor-only edits must not cold-start every user's cache.
CALIBRATION_VERSION = 1

#: The calibration table. Units: LUTs / FFs / DSP48s / BRAM36s for area
#: entries, nanojoules for energy entries (at the paper's ~100 MHz
#: Kintex-7 operating point).
CALIBRATION: Dict[str, object] = {
    # scalar core: the T13 3-hart IMT front end (fetch/decode/regfile),
    # present once regardless of coprocessor scheme
    "core_luts": 7400.0,
    "core_ffs": 3900.0,
    # per-MFU fixed control (sequencer, CSRs, hart arbitration)
    "mfu_base_luts": 450.0,
    "mfu_base_ffs": 260.0,
    # per-lane datapath cost of each internal functional unit at full
    # 32-bit width (multiplier maps to DSP slices)
    "unit_luts_per_lane": {"adder": 110.0, "multiplier": 55.0,
                          "shifter": 85.0, "cmp": 40.0, "move": 20.0},
    "unit_ffs_per_lane": {"adder": 38.0, "multiplier": 64.0,
                          "shifter": 32.0, "cmp": 16.0, "move": 8.0},
    "multiplier_dsps_per_lane": 3.0,
    # sub-word support factor on lane datapath cost (lane splitters,
    # carry breaks, per-subword predication muxes)
    "subword_factor": {32: 1.0, 16: 1.12, 8: 1.25},
    # SPM banks: one BRAM36 holds ~4 KiB; each SPMI adds a base
    # controller plus a per-bank interleaver slice (width D)
    "bram_kbytes": 4.0,
    "spmi_base_luts": 260.0,
    "spmi_base_ffs": 140.0,
    "spmi_luts_per_bank": 90.0,
    "spmi_ffs_per_bank": 42.0,
    # load/store unit (one per SPMI — it rides the interface port)
    "lsu_luts": 520.0,
    "lsu_ffs": 270.0,
    # LUT-equivalent aggregation weights (a DSP48 / BRAM36 in LUT terms,
    # the usual FPGA area-accounting convention)
    "ff_lut_weight": 0.35,
    "dsp_lut_weight": 102.0,
    "bram_lut_weight": 96.0,
    # energy: static power scales with area; dynamic adds per active
    # engine-cycle costs (lane-count weighted for the MFU stream)
    "static_nj_per_cycle_per_kluteq": 0.045,
    "core_nj_per_cycle": 0.35,
    "mfu_nj_per_active_lane_cycle": 0.011,
    "lsu_nj_per_active_cycle": 0.14,
    # low-fidelity cycle estimator (the search tuner's cheap rung):
    # per-op issue/dependency overhead exposed when a hart's own program
    # chain is the bound (per-hart sym/het schemes; in the shared scheme
    # the saturated SPMI hides it), and the contention factor of the
    # heterogeneous scheme's shared unit pool (per-hart dependency
    # chains prevent the perfect cross-unit overlap a pure capacity
    # bound assumes). Fit once against the cycle-accurate simulator on
    # the smoke space (act/est within ~7% per scheme, rank correlation
    # 0.99) — see tests/kvi/test_search.py.
    "est_issue_overhead_cycles": 2.0,
    "est_het_pool_factor": 1.15,
}


@dataclass(frozen=True)
class HardwareCost:
    """FPGA-resource totals for one configuration, with a per-subsystem
    LUT-equivalent breakdown."""

    luts: float
    ffs: float
    dsps: float
    brams: float
    breakdown: Dict[str, float]       # subsystem -> LUT-equivalent area

    @property
    def area_luteq(self) -> float:
        """One aggregate area scalar (LUT equivalents)."""
        c = CALIBRATION
        return (self.luts + c["ff_lut_weight"] * self.ffs
                + c["dsp_lut_weight"] * self.dsps
                + c["bram_lut_weight"] * self.brams)

    def as_dict(self) -> Dict[str, object]:
        return {"luts": round(self.luts, 1), "ffs": round(self.ffs, 1),
                "dsps": round(self.dsps, 1),
                "brams": round(self.brams, 1),
                "area_luteq": round(self.area_luteq, 1),
                "breakdown": {k: round(v, 1)
                              for k, v in self.breakdown.items()}}


def _luteq(luts: float, ffs: float = 0.0, dsps: float = 0.0,
           brams: float = 0.0) -> float:
    c = CALIBRATION
    return (luts + c["ff_lut_weight"] * ffs + c["dsp_lut_weight"] * dsps
            + c["bram_lut_weight"] * brams)


def mfu_cost(cfg: KlessydraConfig) -> Dict[str, float]:
    """LUT/FF/DSP of all F MFUs: per internal unit, ``fu_count``
    instances of a D-lane datapath, scaled by the sub-word factor."""
    c = CALIBRATION
    sub = c["subword_factor"][cfg.subword_bits]
    luts = cfg.F * c["mfu_base_luts"]
    ffs = cfg.F * c["mfu_base_ffs"]
    dsps = 0.0
    for unit in MFU_UNITS:
        n = cfg.F * cfg.fu_count(unit) * cfg.D
        luts += n * c["unit_luts_per_lane"][unit] * sub
        ffs += n * c["unit_ffs_per_lane"][unit] * sub
        if unit == "multiplier":
            dsps += n * c["multiplier_dsps_per_lane"]
    return {"luts": luts, "ffs": ffs, "dsps": dsps}


def spm_cost(cfg: KlessydraConfig) -> Dict[str, float]:
    """BRAM for the SPM arrays plus the M replicated SPMI interleavers
    (width D) and their LSU ports."""
    c = CALIBRATION
    brams = cfg.M * cfg.N * (cfg.spm_kbytes / c["bram_kbytes"])
    luts = cfg.M * (c["spmi_base_luts"]
                    + cfg.D * c["spmi_luts_per_bank"] + c["lsu_luts"])
    ffs = cfg.M * (c["spmi_base_ffs"]
                   + cfg.D * c["spmi_ffs_per_bank"] + c["lsu_ffs"])
    return {"luts": luts, "ffs": ffs, "brams": brams}


def hardware_cost(cfg: KlessydraConfig) -> HardwareCost:
    """The full configuration: scalar core + MFUs + SPM subsystem."""
    c = CALIBRATION
    mfu = mfu_cost(cfg)
    spm = spm_cost(cfg)
    luts = c["core_luts"] + mfu["luts"] + spm["luts"]
    ffs = c["core_ffs"] + mfu["ffs"] + spm["ffs"]
    dsps = mfu["dsps"]
    brams = spm["brams"]
    breakdown = {
        "core": _luteq(c["core_luts"], c["core_ffs"]),
        "mfu": _luteq(mfu["luts"], mfu["ffs"], mfu["dsps"]),
        "spm": _luteq(spm["luts"], spm["ffs"], brams=spm["brams"]),
    }
    return HardwareCost(luts, ffs, dsps, brams, breakdown)


def energy_per_cycle_static(cfg: KlessydraConfig) -> float:
    """Static + clock-tree nJ burned every cycle, area-proportional."""
    c = CALIBRATION
    return (c["core_nj_per_cycle"]
            + c["static_nj_per_cycle_per_kluteq"]
            * hardware_cost(cfg).area_luteq / 1000.0)


#: Calibration-fit gate: maximum per-row relative error of the model's
#: nJ/cycle against the paper's Table 3 measured energies, after the
#: two-parameter dynamic-energy regression below. The current
#: CALIBRATION table fits within ~15%; 0.25 leaves headroom for future
#: retuning without letting the model drift into a different energy
#: regime (2x would mean the static/dynamic split is wrong, not noisy).
CALIBRATION_FIT_MAX_REL_ERR = 0.25

#: Table 3 row label -> the (M, F) of the scheme it measures.
#: the paper's Table 3 — higher-order filters on 32x32, keyed by (core
#: label, D) then filter order: (cycles x1000, T us, E uJ). The port's
#: own copy of the published values (tests hold it equal to the
#: reference's ``benchmarks.paper_data.TABLE3_FILTERS``).
TABLE3_FILTERS = {
    ("T13 SIMD", 2): {5: (53, 362, 51), 7: (101, 694, 97),
                      9: (166, 1136, 159), 11: (247, 1689, 237)},
    ("T13 SIMD", 8): {5: (25, 179, 34), 7: (46, 335, 65),
                      9: (75, 543, 105), 11: (111, 803, 155)},
    ("T13 Sym MIMD", 2): {5: (20, 148, 27), 7: (36, 272, 49),
                          9: (57, 436, 79), 11: (84, 641, 117)},
    ("T13 Sym MIMD", 8): {5: (12, 113, 29), 7: (19, 183, 47),
                          9: (30, 284, 73), 11: (43, 408, 105)},
    ("T13 Het MIMD", 2): {5: (21, 159, 28), 7: (38, 291, 52),
                          9: (60, 467, 83), 11: (89, 687, 122)},
    ("T03", 0): {5: (247, 1120, 216), 7: (515, 2328, 448),
                 9: (881, 3985, 767), 11: (1369, 6191, 1191)},
    ("RI5CY", 0): {5: (180, 1971, 252), 7: (385, 4218, 539),
                   9: (663, 7252, 928), 11: (1000, 10949, 1400)},
    ("ZeroRiscy", 0): {5: (319, 2721, 226), 7: (675, 5754, 479),
                       9: (1130, 9637, 802), 11: (1698, 14482, 1205)},
}

_TABLE3_SCHEMES = {"T13 SIMD": (1, 1), "T13 Sym MIMD": (3, 3),
                   "T13 Het MIMD": (3, 1)}


def calibration_fit(table3: Optional[Dict] = None) -> Dict[str, object]:
    """Regress the energy model against the paper's Table 3 energies.

    Every T13 row of Table 3 gives a measured energy-per-cycle at one
    (scheme, D) operating point: ``E_uJ / kcycles`` nJ/cycle. The model
    predicts ``energy_per_cycle_static(cfg)`` (area-proportional, fully
    determined by :data:`CALIBRATION`) plus a dynamic term the paper's
    table cannot pin per-component — so the dynamic part is regressed
    here as the least-squares line ``a*D + b`` over the residuals
    (``a`` absorbs the lane-count-weighted MFU stream, ``b`` the LSU
    and issue overhead), exactly the shape of
    :func:`energy_model`'s dynamic terms.

    Returns per-row observed/predicted nJ/cycle with relative errors,
    the fitted ``(a, b)``, and ``ok`` — False when ``max_rel_err``
    exceeds :data:`CALIBRATION_FIT_MAX_REL_ERR` (the bench ``--check``
    gate). A failing fit means the CALIBRATION constants have drifted
    out of the paper's energy regime, not that a run was noisy: every
    input here is a published table value."""
    if table3 is None:
        table3 = TABLE3_FILTERS
    rows = []
    for (label, D), by_order in sorted(table3.items()):
        mf = _TABLE3_SCHEMES.get(label)
        if mf is None:                   # baseline cores: no coprocessor
            continue
        cfg = KlessydraConfig(f"{label} D={D}", M=mf[0], F=mf[1], D=D)
        static = energy_per_cycle_static(cfg)
        for order, (kcycles, _t_us, e_uj) in sorted(by_order.items()):
            rows.append({"scheme": label, "D": D, "filter_order": order,
                         "observed_nj_per_cycle": e_uj / kcycles,
                         "static_nj_per_cycle": static})
    resid = np.array([r["observed_nj_per_cycle"]
                      - r["static_nj_per_cycle"] for r in rows])
    lanes = np.array([[r["D"], 1.0] for r in rows])
    (a, b), *_ = np.linalg.lstsq(lanes, resid, rcond=None)
    rel_errs = []
    for r in rows:
        pred = float(r["static_nj_per_cycle"] + a * r["D"] + b)
        r["predicted_nj_per_cycle"] = round(pred, 4)
        r["rel_err"] = round(
            abs(pred - r["observed_nj_per_cycle"])
            / r["observed_nj_per_cycle"], 4)
        r["observed_nj_per_cycle"] = round(
            r["observed_nj_per_cycle"], 4)
        r["static_nj_per_cycle"] = round(r["static_nj_per_cycle"], 4)
        rel_errs.append(r["rel_err"])
    max_err = max(rel_errs)
    return {"rows": rows,
            "dyn_nj_per_lane_cycle": round(float(a), 5),
            "dyn_nj_per_cycle_base": round(float(b), 5),
            "max_rel_err": round(max_err, 4),
            "mean_rel_err": round(float(np.mean(rel_errs)), 4),
            "threshold": CALIBRATION_FIT_MAX_REL_ERR,
            "ok": bool(max_err <= CALIBRATION_FIT_MAX_REL_ERR)}


# ---------------------------------------------------------------------------
# Low-fidelity analytic cycle estimation (the search tuner's cheap rung)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelProfile:
    """Static per-program operand arrays — everything the closed-form
    cycle estimator needs, extracted **once** per optimized program (no
    lowering, no SPM allocation, no simulation). All arrays are aligned
    over the program's coprocessor instructions:

      * ``lengths`` / ``elem_bytes`` — vector shape per op,
      * ``n_src`` — vector sources streamed per result line (the SPMI
        read-port pressure),
      * ``unit_idx`` — index into :data:`~repro_torch.configs.base.MFU_UNITS`
        (-1 for LSU transfers),
      * ``mem_bytes`` — transfer size of LSU ops (0 for MFU ops),
      * ``chainable`` — ops a chaining-enabled lowering would discount
        (interior of a planned fused region, from the same static
        fusion-plan metadata ``lowering._chained_items`` reads).

    The estimator is a *rank* model: it reproduces the contention
    structure (per-scheme serialization, shared LSU port, het per-unit
    pools) that orders design points, not exact cycle counts — the
    search confirms survivors on the cycle-accurate simulator."""

    name: str
    lengths: np.ndarray
    elem_bytes: np.ndarray
    n_src: np.ndarray
    unit_idx: np.ndarray
    mem_bytes: np.ndarray
    chainable: np.ndarray
    n_scalar: int = 0


def kernel_profile(program) -> KernelProfile:
    """Build the :class:`KernelProfile` of one (optimized) KVI program."""
    from repro_torch.kvi.ir import KviInstr
    from repro_torch.kvi.lowering import _chained_items
    from repro_torch.core.isa import OPDEFS

    unit_of = {u: i for i, u in enumerate(MFU_UNITS)}
    chained = _chained_items(program)
    lengths, ebs, n_src, unit_idx, mem_bytes, chainable = \
        [], [], [], [], [], []
    n_scalar = 0
    for idx, it in enumerate(program.items):
        if not isinstance(it, KviInstr):
            n_scalar += it.count
            continue
        od = OPDEFS[it.op.value]
        lengths.append(it.length)
        ebs.append(it.elem_bytes)
        if od.engine == "lsu":
            unit_idx.append(-1)
            n_src.append(0)
            mem_bytes.append(it.length * it.elem_bytes)
        else:
            unit_idx.append(unit_of[od.unit.value])
            n_src.append(max(int(it.src1 is not None)
                             + int(it.src2 is not None), 1))
            mem_bytes.append(0)
        chainable.append(idx in chained)
    return KernelProfile(
        program.name,
        np.asarray(lengths, dtype=np.int64),
        np.asarray(ebs, dtype=np.int64),
        np.asarray(n_src, dtype=np.int64),
        np.asarray(unit_idx, dtype=np.int64),
        np.asarray(mem_bytes, dtype=np.int64),
        np.asarray(chainable, dtype=bool),
        n_scalar)


def estimate_kernel(profile: KernelProfile, cfg: KlessydraConfig,
                    chaining: bool = False) -> Dict[str, float]:
    """Closed-form cycle + energy estimate of the paper's homogeneous
    protocol (``profile`` replicated on every hart of ``cfg``) —
    vectorized numpy over the profile's op arrays, thousands of points
    per second.

    The contention structure mirrors the simulator's resource model:
    per-op SPMI streaming (``n_src`` lines per result line) and
    line-rate unit occupancy; the shared scheme serializes every stream
    on one SPMI, sym-MIMD runs per-hart, het-MIMD pools F x fu_count
    instances per internal unit; the single 32-bit memory port is
    shared by all schemes."""
    H = cfg.harts
    setup = cfg.vector_setup_cycles
    is_mfu = profile.unit_idx >= 0
    eff_eb = np.maximum(profile.elem_bytes, cfg.subword_bits // 8)
    lanes = cfg.D * np.maximum(1, 4 // eff_eb)
    lines = np.ceil(profile.lengths / np.maximum(lanes, 1)).astype(np.int64)
    unit_c = np.where(is_mfu, setup + lines, 0)
    spmi_c = np.where(is_mfu, setup + profile.n_src * lines, 0)
    lsu_c = np.where(
        ~is_mfu,
        setup + cfg.mem_latency_cycles
        + np.ceil(profile.mem_bytes / cfg.mem_port_bytes).astype(np.int64),
        0)
    if chaining:
        disc = np.where(profile.chainable & is_mfu, setup, 0)
        unit_c = np.maximum(np.where(is_mfu, 1, 0), unit_c - disc)
        spmi_c = np.maximum(np.where(is_mfu, 1, 0), spmi_c - disc)
    op_dur = np.maximum(np.maximum(unit_c, spmi_c), lsu_c)

    c0 = CALIBRATION["est_issue_overhead_cycles"]
    if cfg.M == 1 and cfg.F == 1:            # shared: one SPMI, one MFU
        est = H * float(op_dur.sum()) + profile.n_scalar
    else:
        t_serial = float((op_dur + c0).sum()) + profile.n_scalar
        t_lsu = float(lsu_c.sum()) + c0 * int((~is_mfu).sum())
        if cfg.F == cfg.M and cfg.F > 1:     # sym: only the LSU port shared
            est = max(t_serial, H * t_lsu)
        else:                                # het: per-internal-unit pools
            pool_bound = 0.0
            for i, unit in enumerate(MFU_UNITS):
                tu = float(unit_c[profile.unit_idx == i].sum())
                pool_bound = max(pool_bound,
                                 H * tu / (cfg.F * cfg.fu_count(unit)))
            est = CALIBRATION["est_het_pool_factor"] \
                * max(t_serial, H * t_lsu, pool_bound)
    est = max(est, 1.0)

    mfu_busy = H * float(np.where(is_mfu, op_dur, 0).sum())
    lsu_busy = H * float(lsu_c.sum())
    static = energy_per_cycle_static(cfg) * est
    c = CALIBRATION
    energy = (static + c["mfu_nj_per_active_lane_cycle"] * cfg.D * mfu_busy
              + c["lsu_nj_per_active_cycle"] * lsu_busy)
    return {"est_cycles": est, "est_energy_nj": energy}


def batch_estimate(profiles: Dict[str, KernelProfile], points,
                   ) -> List[Dict[str, object]]:
    """Low-fidelity scores for an explicit point list: per point, the
    analytic area plus per-kernel ``est_cycles`` / ``est_energy_nj``.
    ``profiles`` may be keyed per precision (``(precision_bits ->
    {kernel: profile})``) or flat (``{kernel: profile}`` applied to all
    points). Pure closed-form — safe to call on thousands of points."""
    out: List[Dict[str, object]] = []
    per_prec = profiles and all(
        isinstance(k, int) for k in profiles)
    for pt in points:
        cfg = pt.config()
        kern_profiles = profiles[pt.precision_bits] if per_prec \
            else profiles
        row: Dict[str, object] = {
            "point": pt.name,
            "area_luteq": hardware_cost(cfg).area_luteq,
            "kernels": {name: estimate_kernel(prof, cfg,
                                              chaining=pt.chaining)
                        for name, prof in kern_profiles.items()}}
        out.append(row)
    return out


def energy_model(cfg: KlessydraConfig, sim) -> Dict[str, float]:
    """Energy of one simulated run (``sim`` is a
    :class:`~repro_torch.core.simulator.SimResult`): static power for the
    whole window plus dynamic energy for the MFU-stream and LSU busy
    cycles. Lane-count weights the MFU stream (D banks switching), with
    sub-word packing holding the switched width constant — narrow
    elements save energy through *fewer cycles*, not cheaper cycles."""
    c = CALIBRATION
    lanes = cfg.D
    static = energy_per_cycle_static(cfg) * sim.cycles
    mfu_dyn = c["mfu_nj_per_active_lane_cycle"] * lanes * sim.mfu_busy_cycles
    lsu_dyn = c["lsu_nj_per_active_cycle"] * sim.lsu_busy_cycles
    total = static + mfu_dyn + lsu_dyn
    return {"energy_nj": total, "static_nj": static,
            "mfu_dynamic_nj": mfu_dyn, "lsu_dynamic_nj": lsu_dyn,
            "nj_per_cycle": total / max(sim.cycles, 1)}

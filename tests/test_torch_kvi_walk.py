"""The KVI walk kernel's packed table on the CPU: ``run_walk_plain`` (what
``TorchBackend(device="cpu")`` runs) against the reference ``oracle``, bit
for bit, with the programs reached through ``program_from_reference``;
``pack_walk``'s encoding (round trip, barriers, layouts) and the card
checks' helpers rehearsed with the plain version. The kernel itself is
held against ``run_walk_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kvi import KviProgramBuilder, KviWorkload, get_backend
from repro.kvi.programs import (conv2d_program, fft_program, matmul_program,
                                pipeline_demo_program)
import repro_torch.kvi as tk
from repro_torch.kernels import checks
from repro_torch.kernels import kvi_walk as kw
from repro_torch.kvi.torch_backend import TorchBackend

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("conv8_f3", "conv8_f5", "fft32", "matmul8_streamed",
         "matmul8_streamed_shift", "matmul8_resident",
         "matmul8_resident_shift", "demo")


def _instances(kind, eb, rng, n=3):
    lim = {1: 8, 2: 60, 4: 1000}[eb]
    filt = rng.integers(-4, 5, (5, 5) if kind == "conv8_f5" else (3, 3))
    A = rng.integers(-lim, lim, (8, 8))
    out = []
    for _ in range(n):
        x = rng.integers(-lim, lim, (8, 8))
        if kind.startswith("conv8"):
            p = conv2d_program(x, filt, shift=2, elem_bytes=eb)
        elif kind == "fft32":
            p = fft_program(rng.integers(-lim, lim, 32),
                            rng.integers(-lim, lim, 32), elem_bytes=eb)
        elif kind.startswith("matmul8"):
            resident = "resident" in kind
            p = matmul_program(A if resident else x,
                               rng.integers(-lim, lim, (8, 8)),
                               shift=5 if kind.endswith("shift") else 0,
                               resident=resident, elem_bytes=eb)
        else:
            p = pipeline_demo_program(rng.integers(-100, 100, 32))
        out.append(p)
    return out


def _port(workload):
    return tk.KviWorkload(workload.name, tuple(
        tk.WorkloadEntry(tk.program_from_reference(e.program),
                         tk.HartAssignment(e.hart))
        for e in workload.entries))


def _assert_same_outputs(got, want):
    assert len(got.entry_results) == len(want.entry_results)
    for g, w in zip(got.entry_results, want.entry_results):
        assert g.outputs.keys() == w.outputs.keys()
        for name, arr in w.outputs.items():
            assert g.outputs[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(g.outputs[name], arr, err_msg=name)


def _walk_steps(walk):
    """The compiled walk's steps in ``decode_steps``' form."""
    out = []
    for s in walk.steps:
        if s[0] == "copy":
            out.append(s)
        elif s[0] == "fused":
            _, region, reg, win = s
            out.append(("fused", region.ops,
                        tuple(x for _, x in region.inputs),
                        tuple(x for _, x in region.outputs), region.n_slots,
                        reg, tuple(win.in_cols.tolist()),
                        tuple(win.out_cols.tolist()), win.n))
        else:
            _, _op, scalar, post, n, akey, acol, bcol, dkey, dcol = s
            out.append(("reduce", post, scalar, n, akey, acol, bcol, dkey,
                        dcol))
    return out


def _opens_with_sync(word):
    return word[0] & 0xff == kw.FUSED or bool(word[0] & kw.PREFETCH)


def _closes_with_sync(word):
    return bool(word[0] & kw.BARRIER)


def _accesses(record):
    """(reads, writes) of every step as (buffer, lo, hi, lane), from the
    table alone: ``lane`` where element e is thread e % threads's (every
    access but an overlapping copy's, a hazard region's writes and a
    reduction's dst, which thread 0 writes). Input stacks are never
    written, so their reads are left out."""
    pool = record.pool.tolist()
    space = [b.key[0] for b in record.buffers]
    out = []
    for w in record.table.tolist():
        kind = w[0] & 0xff
        if kind == kw.COPY:
            lane = not w[0] & kw.OVERLAP
            reads = [] if space[w[3]] == "in" else [
                (w[3], w[4], w[4] + w[5], lane)]
            out.append((reads, [(w[1], w[2], w[2] + w[5], lane)]))
        elif kind == kw.FUSED:
            p = w[2] + 2 * w[3] + w[4] + w[5]
            ins, outs = pool[p:p + w[4]], pool[p + w[4]:p + w[4] + w[5]]
            lane = not w[0] & kw.HAZARD
            out.append(([(w[1], c, c + w[6], True) for c in ins],
                        [(w[1], c, c + w[6], lane) for c in outs]))
        else:
            reads = [(w[1], w[2], w[2] + w[4], True)]
            if w[3] >= 0:
                reads.append((w[1], w[3], w[3] + w[4], True))
            out.append((reads, [(w[5] & 0xff, w[6], w[6] + 1, False)]))
    return out


def _conflict(a, b):
    """Overlapping accesses whose shared elements may be two threads'."""
    same_thread = a[3] and b[3] and a[1] == b[1]
    return a[0] == b[0] and a[1] < b[2] and b[1] < a[2] and not same_thread


def _assert_barriers_cover_hazards(record):
    """Every pair of steps where one writes what the other reads or
    writes has a sync between them: for each step, the earlier steps back
    to the nearest sync must not conflict with it (checked from the table
    alone, independently of ``pack_walk``'s running analysis)."""
    words = record.table.tolist()
    acc = _accesses(record)
    ov = _conflict
    for j in range(1, len(words)):
        if _opens_with_sync(words[j]):
            continue
        rj, wj = acc[j]
        for i in range(j - 1, -1, -1):
            if _closes_with_sync(words[i]):
                break
            ri, wi = acc[i]
            assert not (any(ov(a, b) for a in wi for b in rj + wj)
                        or any(ov(a, b) for a in ri for b in wj)), \
                (i, j, words[i], words[j])
            if _opens_with_sync(words[i]):
                break


def _check_record(be):
    for walk, record in be._walks.values():
        assert kw.decode_steps(record) == _walk_steps(walk)
        _assert_barriers_cover_hazards(record)
        assert record.smem_bytes <= kw.MAX_SMEM
        assert record.threads % 32 == 0


@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_bit_exact_vs_oracle(kind, eb):
    rng = np.random.default_rng(10 * KINDS.index(kind) + eb)
    wl = KviWorkload.homogeneous(_instances(kind, eb, rng))
    be = TorchBackend(device="cpu")
    got = be.run_workload(_port(wl))
    _assert_same_outputs(got, get_backend("oracle").run_workload(wl))
    assert be.walk_calls == 0                  # the card's count only
    (walk, record), = be._walks.values()
    assert got.kernel_launches == record.counts["fused"] \
        + record.counts["reduce"]
    _check_record(be)


@pytest.mark.parametrize("passes", [None, ()])
@pytest.mark.parametrize("eb", [1, 2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_random_programs_bit_exact_vs_oracle(seed, eb, passes):
    rng = np.random.default_rng(7000 + 10 * seed + eb)
    progs = [checks.random_kvi_program(KviProgramBuilder, rng, eb)]
    progs.append(progs[0].replace(mem_init={
        k: rng.permutation(v) for k, v in progs[0].mem_init.items()}))
    wl = KviWorkload.homogeneous(progs)
    be = TorchBackend(device="cpu", passes=passes)
    got = be.run_workload(_port(wl))
    _assert_same_outputs(got, get_backend("oracle").run_workload(wl))
    _check_record(be)


EDGES = ("overlap_kvcp", "hazard", "load_after_store",
         "unsigned_into_narrow", "narrow_dst_reduce", "mixed_widths",
         "big_regfile")


def _edge_record(name, be):
    (walk, record), = be._walks.values()
    flags = [w[0] for w in record.table.tolist()]
    if name == "overlap_kvcp":
        assert sum(bool(f & kw.OVERLAP) for f in flags) == 4
        assert record.threads < 300      # the long copies take 3 chunks
        assert record.ring == 1
    elif name == "hazard":
        assert sum(bool(f & kw.HAZARD) for f in flags) >= 1
        assert record.arena_bytes > record.scratch_off
    elif name == "load_after_store":
        srcs = [record.buffers[s[3]].key[0] for s in record.table.tolist()
                if s[0] & 0xff == kw.COPY]
        assert "st" in srcs                  # the kmemld reads the store
    elif name == "unsigned_into_narrow":
        assert {np.dtype(k[1]) for k in record.in_keys} == {
            np.dtype(np.int64), np.dtype(np.uint8)}
    elif name == "narrow_dst_reduce":
        dst = {record.buffers[w[5] & 0xff].key[1]
               for w in record.table.tolist() if w[0] & 0xff == kw.REDUCE}
        assert dst == {torch.int8, torch.int16}
    elif name == "mixed_widths":
        assert {k[1] for k in record.keys("reg")} == {
            torch.int8, torch.int16, torch.int32}
        offs = [b.offset for b in record.buffers if b.space == kw.ARENA]
        assert all(o % 16 == 0 for o in offs)
    else:
        assert record.layout == "global"
        assert record.arena_bytes > kw.ARENA_SMEM_CAP
    if name != "big_regfile":
        assert record.layout == "shared"


@pytest.mark.parametrize("name", EDGES)
def test_edge_programs_bit_exact_vs_oracle(name):
    prog = checks.walk_edge_programs(KviProgramBuilder,
                                     np.random.default_rng(31))[name]
    progs = [prog, prog.replace(mem_init={
        k: np.random.default_rng(k).permutation(v)
        for k, v in prog.mem_init.items()})]
    wl = KviWorkload.homogeneous(progs)
    be = TorchBackend(device="cpu", passes=())
    got = be.run_workload(_port(wl))
    _assert_same_outputs(got, get_backend("oracle").run_workload(wl))
    _check_record(be)
    _edge_record(name, be)


def _paper_protos():
    """The main path's five structures at the paper's sizes, optimized
    as ``chip_smoke.py`` runs them (numbers from a seed; one instance)."""
    from repro_torch.kvi.programs import (conv2d_program as c2d,
                                          fft_program as fft,
                                          matmul_program as mm,
                                          pipeline_demo_program as demo)
    rng = np.random.default_rng(0)
    return {
        "conv32_f3": tk.optimize_program(c2d(
            rng.integers(-99, 99, (32, 32)), rng.integers(-9, 9, (3, 3)),
            shift=4)),
        "conv32_f11": tk.optimize_program(c2d(
            rng.integers(-99, 99, (32, 32)), rng.integers(-9, 9, (11, 11)),
            shift=4)),
        "fft256": tk.optimize_program(fft(rng.integers(-99, 99, 256),
                                          rng.integers(-99, 99, 256))),
        "matmul64": tk.optimize_program(mm(
            rng.integers(-99, 99, (64, 64)), rng.integers(-99, 99, (64, 64)),
            resident=False)),
        "pipeline_demo": tk.optimize_program(demo(
            rng.integers(-99, 99, 1024), stages=6))}


# copy / fused / reduce steps, register-file int32 lanes, ring depth
PAPER_WALKS = {"conv32_f3": (33, 32, 0, 1220), "conv32_f11": (33, 192, 0, 1828),
               "fft256": (532, 61, 0, 2046), "matmul64": (4224, 0, 4096, 192),
               "pipeline_demo": (2, 1, 0, 7168)}


def test_main_path_walks_pack_as_measured():
    """The main path's walks: their step counts, register files, one
    table whatever N, every arena in shared memory, and the barriers
    cover every hazard."""
    for name, proto in _paper_protos().items():
        walk = checks.compile_walk(proto)
        record = kw.pack_walk(walk)
        copies, fused, reduce, lanes = PAPER_WALKS[name]
        assert (record.counts["copy"], record.counts["fused"],
                record.counts["reduce"]) == (copies, fused, reduce), name
        assert walk.reg_width == {torch.int32: lanes}, name
        assert record.layout == "shared" and record.smem_bytes <= kw.MAX_SMEM
        assert kw.decode_steps(record) == _walk_steps(walk)
        assert torch.equal(kw.pack_walk(walk).table, record.table)
        if name == "matmul64":
            assert record.counts["prefetched"] == 4160
            assert record.ring == kw.MAX_RING and record.threads == kw.THREADS
            _assert_barriers_cover_hazards(record)


def test_both_layouts_and_the_grid_run_alike_on_the_cpu():
    """``check_walk`` (the card check) rehearsed with the plain version:
    one walk packed in the shared and the global layout gives the same
    table, and the check passes."""
    rng = np.random.default_rng(3)
    prog = checks.random_kvi_program(tk.KviProgramBuilder, rng, 2)
    walk = checks.compile_walk(prog)
    shared = checks.check_walk(rng, walk, 5, "cpu")
    glob = checks.check_walk(rng, walk, 5, "cpu", smem_cap=0)
    assert (shared.layout, glob.layout) == ("shared", "global")
    assert torch.equal(shared.table, glob.table)
    assert glob.smem_bytes == shared.smem_bytes - shared.arena_bytes


def test_run_walk_is_the_card_path_only():
    """No fallback: ``run_walk`` on CPU tensors raises; ``run_walk_plain``
    is the CPU's route and does not count as a launch."""
    prog = checks.walk_edge_programs(tk.KviProgramBuilder,
                                     np.random.default_rng(1))["hazard"]
    record = kw.pack_walk(checks.compile_walk(prog))
    ins = [torch.zeros((2, record.width(k)), dtype=torch.int32)
           for k in record.in_keys]
    sts = [torch.zeros((2, record.width(k)), dtype=torch.int32)
           for k in record.st_keys]
    before = kw.launch_count
    with pytest.raises(ValueError, match="CUDA"):
        kw.run_walk(record, ins, sts, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kw.run_walk_plain(record, ins, [t[:1] for t in sts], 2)
    kw.run_walk_plain(record, ins, sts, 2)
    assert kw.launch_count == before


def test_pack_walk_refuses_what_the_kernel_cannot_take():
    walk = checks.compile_walk(checks.walk_edge_programs(
        tk.KviProgramBuilder, np.random.default_rng(2))["mixed_widths"])
    with pytest.raises(ValueError, match="threads"):
        kw.pack_walk(walk, threads=512)
    b = tk.KviProgramBuilder("f16")
    x = b.vreg("x", 8)
    b.kmemld(x, b.mem_in("x", np.ones(8, np.float16)))
    b.kmemstr(b.mem_out("y", 8), x)
    with pytest.raises(TypeError, match="float16"):
        kw.pack_walk(checks.compile_walk(b.build()))


def test_backend_meta_and_host_split_on_the_cpu():
    rng = np.random.default_rng(4)
    wl = _port(KviWorkload.homogeneous(_instances("fft32", 4, rng)))
    be = TorchBackend(device="cpu")
    res = be.run_workload(wl)
    assert set(res.meta) == {"groups", "kernel_launches", "compile_cache",
                             "wall_s"}
    assert set(be.host_s) == {"stack_s", "walk_s", "unpack_s"}
    assert all(v >= 0 for v in be.host_s.values())
    again = be.run_workload(wl)
    assert again.meta["compile_cache"] == {"hits": again.kernel_launches,
                                           "misses": 0}
    assert len(be._walks) == 1 and be.walk_calls == 0


def test_chip_smoke_walk_checks_rehearsed_on_the_cpu(capsys):
    """``chip_smoke.check_walks`` (phase 2's walk checks) at a tiny batch
    on the CPU: every structure, random program and edge program packs,
    and the plain version equals itself through the check."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.check_walks(np.random.default_rng(0), "cpu", scale=64,
                            big_lanes=26000)
    assert out["layouts"] == {"shared", "global"}
    assert out["cases"] >= 20


def test_prefetch_words_follow_the_table():
    """Every prefetched copy carries the packed source of the prefetch
    ``ring - 1`` loads ahead, the pool the first ``ring - 1``, and the
    element codes in the step head are the buffers' own."""
    walk = checks.compile_walk(_paper_protos()["fft256"])
    record = kw.pack_walk(walk)
    words = record.table.tolist()
    srcs = [w for w in words if w[0] & kw.PREFETCH]
    packed = [w[3] | record.buffers[w[3]].elem << 4 | w[5] << 8 | w[4] << 36
              for w in srcs]
    assert [w[6] for w in srcs] == list(range(len(srcs)))
    lead = record.ring - 1
    assert record.pool.tolist()[record.pf_off:] == packed[:lead]
    assert [w[7] for w in srcs] == packed[lead:] + [-1] * lead
    for w in words:
        kind = w[0] & 0xff
        a, b = (w[0] >> 16) & 0xff, (w[0] >> 24) & 0xff
        if kind == kw.COPY:
            assert (a, b) == (record.buffers[w[1]].elem,
                              record.buffers[w[3]].elem)
        elif kind == kw.FUSED:
            assert a == record.buffers[w[1]].elem

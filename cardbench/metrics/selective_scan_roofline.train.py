"""The selective scan's share of the card's HBM roofline in a traced
training step, %: the scan's compulsory bytes a step (every layer's
forward, recompute and backward, each input read and each output
written once; ``flops/hybrid.py``, from the widths of the cell's
configuration, whatever implements the scan) over the device time of the
program's ``selective_scan`` spans, as a share of 3.35 TB/s.

The kind's context carries no configuration, so the reader takes it from
the one cell whose program opens these spans, ``CELL``, and reads
nothing where a step's tokens are not that cell's."""
from cardbench.harness import manifest
from cardbench.harness.program_spans import per_step_ms

UNIT, LAYER, MOVES = "%", "ssm mixer", "train_tokens_per_s"
CELL = "train.hymba-1.5b.s1k"


def read(ctx):
    ms = per_step_ms(ctx, "selective_scan")
    if not ms:
        return None
    cell = manifest.load_cell(manifest.BENCH_DIR.parent / "BENCHMARK.json",
                              CELL)
    mix, m = cell.traffic, cell.config["model"]
    if ctx.get("tokens_per_step") != mix["batch"] * mix["seq"]:
        return None
    fam = manifest.load_code("flops", m["family"])
    nbytes = fam.scan_step_bytes(m, mix["batch"], mix["seq"])
    return 100.0 * nbytes / (ms * 1e-3) / fam.HBM_BYTES_PER_S

"""Device milliseconds a traced training step spends in operations that
are not matrix products (elementwise passes, reductions, copies), from
the profiler's device events. A device operation counts as a matrix
product when its name matches ``MATMUL``: cuBLAS / cuBLASLt / CUTLASS
GEMM and GEMV kernels as the H100 names them."""
import re

UNIT, LAYER, MOVES = "ms", "kernels", "train_tokens_per_s"
MATMUL = re.compile(r"gemm|gemv|cutlass|nvjet|xmma|wgmma|cublas|"
                    r"s884|s1688|s16816|h884|h1688|h16816|hmma|bmm",
                    re.IGNORECASE)


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or not t or t["busy_s"] <= 0:
        return None
    other = sum(s for name, s in t["device_s"].items()
                if not MATMUL.search(name))
    return 1e3 * other / t["steps"]

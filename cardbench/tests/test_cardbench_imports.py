"""Nothing under cardbench/ imports JAX or the JAX package (``repro``),
top-level names compared whole; the reference imports torch alone of
what is not the standard library."""
import ast
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "cardbench").rglob("*.py")]
    assert len(files) > 20
    for p in files:
        bad = set(_imports(p)) & FORBIDDEN
        assert not bad, (p, bad)
    # the port's name begins with the JAX package's: compared whole
    assert "repro_torch" not in FORBIDDEN


def test_the_reference_imports_torch_alone():
    allowed = {"torch", "__future__"} | set(sys.stdlib_module_names)
    for p in (ROOT / "cardbench" / "reference").glob("*.py"):
        names = set(_imports(p))
        assert names <= allowed, (p, names - allowed)
        assert not names & {"repro_torch", "cardbench", "numpy"}

"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port either (whole top-level module
names: the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "whisperjav_tpu", "bench"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_found():
    assert BENCH / "run.py" in SOURCES
    assert BENCH / "reference" / "whisper.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_level_imports(path) <= {"__future__", "typing", "numpy",
                                       "torch"}


def test_the_port_is_not_the_jax_package():
    names = top_level_imports(BENCH / "drivers" / "whisper.py")
    assert "whisperjav_tpu_torch" in names
    assert "whisperjav_tpu" not in names


def imports(path: Path) -> set:
    """Every module ``path`` imports, by its whole dotted name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", [BENCH / "run.py", BENCH / "calibrate.py"]
                         + sorted((BENCH / "h100bench").glob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_loop_knows_no_model(path):
    """The command, the calibration and the harness reach the program
    and its reference only through a driver: no reference, no module of
    the port's models or pipelines (the port's package itself and its
    tracer are every driver's)."""
    for name in imports(path):
        assert name.split(".")[0] not in ("reference", "drivers"), name
        assert name in ("whisperjav_tpu_torch",
                        "whisperjav_tpu_torch.utils.tracer") \
            or not name.startswith("whisperjav_tpu_torch"), name

"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the program."""
import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

BENCH = ROOT / "perfbench"


def imported_tops(path: Path) -> set:
    """Top-level names of every module a file imports (whole names)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_jax_in_the_benchmark():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = imported_tops(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{f}: {bad}"


def test_references_import_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        tops = imported_tops(f)
        assert "repro_torch" not in tops and "repro" not in tops, f
        assert tops <= {"__future__", "math", "torch", "numpy", "perfbench",
                        "importlib"}
        # within the benchmark, only the reference package itself
        text = f.read_text()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("perfbench"):
                assert node.module.startswith("perfbench.reference"), f


def test_layer_parts_are_found_inside_the_reference():
    """``lm.part`` loads a mixer or an MLP by its kind from the reference's
    own folders, and from nowhere else."""
    from perfbench.reference import lm
    for family, kind in (("mixers", "attn"), ("mixers", "mamba2"),
                         ("mlps", "glu")):
        fn = lm.part(family, kind)
        assert fn.__module__ == f"perfbench.reference.{family}.{kind}"
    with pytest.raises(ModuleNotFoundError):
        lm.part("mixers", "moe")


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.models", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]
    assert imported_tops(BENCH / "harness.py") >= {"json", "argparse"}

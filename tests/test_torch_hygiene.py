"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card or raise, never on the CPU by default."""
import ast
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_checker_imports_no_torch():
    """None of ``repro_torch.analysis``' modules imports torch, so
    ``python -m repro_torch.analysis`` runs in a bare interpreter (only
    ``explore`` reaches the runtime, ``repro_torch.core``)."""
    files = sorted((ROOT / "src" / "repro_torch" / "analysis").glob("*.py"))
    assert len(files) == 16
    for path in files:
        bad = {m for m in _imported_modules(path)
               if m.split(".")[0] == "torch"}
        assert not bad, f"{path.name} imports {sorted(bad)}"


def test_sharding_and_launch_are_held_to_it():
    """The sharding and dry-run packages are among the files above (no
    jax, no repro), and so is the kernels' DTensor route."""
    names = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES[:-1]}
    assert {"repro_torch/parallel/annotate.py",
            "repro_torch/parallel/sharding.py",
            "repro_torch/launch/mesh.py", "repro_torch/launch/roofline.py",
            "repro_torch/launch/dryrun.py",
            "repro_torch/kernels/sharded.py",
            "repro_torch/kernels/meta.py"} <= names


def test_port_has_sources():
    assert len(PORT_FILES) > 10
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "flash_attention.cu", "flash_attention_bwd.cu",
        "decode_attention.cu", "decode_attention_hd.cu",
        "mamba_chunk_scan.cu",
        "mamba_chunk_scan_bwd.cu", "rmsnorm.cu"}


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import configs
    from repro_torch.device import default_device
    from repro_torch.models import model
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.trainer import MicrobatchCoordinator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(cfg, 1, 8)
    params = model.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MicrobatchCoordinator(cfg)


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_worker_import_chain_has_no_torch():
    """A spawned worker of the process runtime imports the task runtime to
    run ``_worker_main``; that chain pulls in no torch (and nothing of
    JAX): read from a fresh interpreter's ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        from repro_torch.core.runtime import _worker_main
        import repro_torch.core, repro_torch.core.benchgraphs
        import repro_torch.ft.faults
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "repro"))
        print(",".join(bad) or "clean")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_as_a_spawned_worker_imports_no_torch():
    """A worker of chip_smoke's process runtime imports the script as
    ``__mp_main__``: its top level then imports no torch and does no work
    beyond imports and constants."""
    code = textwrap.dedent(f"""
        import runpy, sys
        ns = runpy.run_path({str(ROOT / "chip_smoke.py")!r},
                            run_name="__mp_main__")
        assert "main" in ns and "rt_torch_state" in ns
        print(ns["rt_torch_state"](),
              sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax")) or "clean")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["absent", "clean"]

"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card or raise, never on the CPU by default."""
import ast
import importlib.util
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


def test_port_has_sources():
    assert len(PORT_FILES) > 10
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "flash_attention.cu", "flash_attention_bwd.cu",
        "decode_attention.cu", "mamba_chunk_scan.cu",
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

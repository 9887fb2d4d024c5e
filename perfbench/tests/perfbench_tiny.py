"""A copy of the benchmark at smoke sizes, for driving whole runs on the
CPU: the cells' configurations keep their layer kinds at tiny widths, the
mixes their shapes at a few tokens."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DENSE = dict(
    groups=[{"pattern": [{"kind": "attn", "mlp": "glu"}], "repeat": 2}],
    d_model=64, num_heads=8, num_kv_heads=2, head_dim=8, d_ff=160,
    vocab_size=256)
MODELS = {"deepseek-coder-33b-31L": DENSE, "deepseek-coder-33b-4L": DENSE}
# Mamba-2 layers and a shared attention block (the port's zamba2 pattern),
# for the reference's ``mamba2`` mixer; no cell runs it
HYBRID = dict(
    name="hybrid-smoke",
    groups=[{"pattern": [{"kind": "mamba2", "mlp": "none"}] * 2 + [
        {"kind": "attn", "mlp": "glu", "shared": True}], "repeat": 2}],
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256, mamba={"d_state": 16, "d_conv": 4, "expand": 2,
                           "head_dim": 32, "chunk": 16},
    activation="gelu", tie_embeddings=True, subquadratic=True,
    rope_theta=10000.0, norm_eps=1e-6, remat="full")
MIXES = {
    "code_complete": dict(
        clients=4, slots=4, max_len=128, stagger_s=0.01, pool=32,
        prompt_tokens={"dist": "fixed", "tokens": 24},
        new_tokens={"dist": "fixed", "tokens": 4},
        check={"requests": 3}),
    "train_4x2048": dict(batch=2, seq_len=32),
}


def make(dst: Path, dtype: str = "float32") -> Path:
    """A checkout at ``dst``: the benchmark's files with tiny models (in
    ``dtype``) and mixes, and the port's sources linked."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dst / c["file"]
        doc = json.loads(path.read_text())
        doc["model"].update(MODELS[c["name"]], dtype=dtype)
        path.write_text(json.dumps(doc))
    for name, small in MIXES.items():
        path = dst / "perfbench" / "traffic" / f"{name}.json"
        doc = json.loads(path.read_text())
        doc.update(small)
        path.write_text(json.dumps(doc))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst

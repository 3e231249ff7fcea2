"""Guards of the PyTorch port: it imports no jax and nothing of ``repro``,
and a CUDA request with no card raises instead of running on the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_sources_import_no_jax_and_no_reference_package():
    for path in SOURCES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    for m in ("repro_torch.models.rwkv6", "repro_torch.models.rglru",
              "repro_torch.models.moe", "repro_torch.models.moe_a2a",
              "repro_torch.configs.rwkv6_1_6b",
              "repro_torch.configs.recurrentgemma_9b",
              "repro_torch.configs.qwen3_moe_235b_a22b",
              "repro_torch.configs.dbrx_132b",
              "repro_torch.training.codesign"):
        assert m in mods, m
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {list(_modules())!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_request_without_card_raises(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import align, cim
    from repro_torch.kernels.cim_read import ops
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w, _ = align.align_matrix(torch.randn(64, 32) * 0.05,
                              align.AlignmentConfig())
    store = cim.pack(w, cim.CIMConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.cim_linear_store(torch.randn(2, 64), store)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.cim_linear_store(torch.randn(2, 64), store, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--gen", "2", "--prompt-len", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):   # LM(cfg) means cuda
        LM(get_config("olmo-1b").reduced())
    # the CPU is used only when asked for
    assert ops.cim_linear_store(torch.randn(2, 64), store,
                                device="cpu").shape == (2, 32)


def test_train_entry_points_without_card_raise(monkeypatch):
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import train
    from repro_torch.training.loop import run_training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--rel-mode", "align"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--device", "cuda"])
    cfg = get_config("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):   # no device means cuda
        run_training(cfg, RunConfig(steps=1, checkpoint_dir=""),
                     iter(MarkovLM(cfg.vocab_size, 8, 2)))


def test_chip_smoke_refuses_without_card_or_sources(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal paths are not reachable")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout

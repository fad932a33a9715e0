"""The port stands alone: ``glom_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor ``glom_tpu``, and its entry points never move to the CPU on
their own."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import glom_tpu_torch
from glom_tpu_torch import Glom
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.serving import server
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.training import train
from glom_tpu_torch.training.trainer import Trainer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "glom_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(glom_tpu_torch.__path__, "glom_tpu_torch."))


def _port_sources():
    paths = [SMOKE]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _is_reference(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "glom_tpu")


def test_importing_the_port_loads_no_jax_and_no_glom_tpu():
    mods = _port_modules()
    assert {"glom_tpu_torch.serving.server", "glom_tpu_torch.kernels.ff",
            "glom_tpu_torch.training.trainer", "glom_tpu_torch.training.train",
            "glom_tpu_torch.training.optim", "glom_tpu_torch.training.data",
            "glom_tpu_torch.training.metrics", "glom_tpu_torch.obs.monitors",
            "glom_tpu_torch.resilience.integrity"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'glom_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_of_the_port_imports_jax_or_glom_tpu():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                          for n in names if _is_reference(n)]
    assert len(_port_sources()) > 28
    assert not offenders, offenders


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_cuda, tmp_path):
    make_demo_checkpoint(str(tmp_path), config=GlomConfig(dim=32, levels=3, image_size=16,
                                                          patch_size=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Glom()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--checkpoint-dir", str(tmp_path), "--port", "0"])
    tiny = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny, TrainConfig(batch_size=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--dim", "32", "--levels", "3", "--image-size", "16", "--patch-size", "4",
                    "--steps", "1"])
    # asking for the CPU is the one way onto it
    assert ServingEngine(str(tmp_path), device="cpu").device.type == "cpu"
    assert Glom(dim=32, levels=3, image_size=16, patch_size=4, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(no_cuda, capsys):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Run without the rest of the repo, the script fails and prints no result."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

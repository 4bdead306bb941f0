"""paddle_tpu_torch stands alone: it imports neither jax nor paddle_tpu,
and its entry points run on the card unless asked for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import LlamaModel
from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from paddle_tpu_torch.models.llama import (LlamaConfig, init_kv_cache,
                                           init_llama_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file runs (the suite runs several
    pytest-xdist workers side by side); restored after, so other files
    in the same worker keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKG_DIR = os.path.dirname(paddle_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="paddle_tpu_torch."))


def test_import_pulls_in_no_jax_and_no_reference_package():
    mods = ["paddle_tpu_torch"] + _submodules()
    assert "paddle_tpu_torch.inference.serving" in mods
    assert "paddle_tpu_torch.kernels.fused_ce" in mods
    for new in ("kernels.registry", "kernels.fused_update", "models.llama",
                "inference.spec_decode", "inference.multi_tick",
                "inference.host_kv"):
        assert f"paddle_tpu_torch.{new}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'paddle_tpu' or "
            "k.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout


def _sources():
    """Every .py of the package, and chip_smoke.py, which the same rule
    covers."""
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_or_reference_import_in_source():
    found = []
    sources = list(_sources())
    assert os.path.join(REPO, "chip_smoke.py") in sources
    for path in sources:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
                    found.append(f"{path}:{node.lineno} {n}")
    assert not found, found


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                    num_heads=2, max_seq_len=16, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        init_gpt_params(cfg)
    params = init_gpt_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, cfg)
    eng = ServingEngine(params, cfg, num_slots=1, device="cpu")
    out = eng.generate([np.array([1, 2, 3])], 2)
    assert len(out[0]) == 2
    lcfg = LlamaConfig(vocab_size=32, hidden_size=16, num_layers=1,
                       num_heads=2, num_kv_heads=1, max_seq_len=16,
                       dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_llama_params(lcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaModel(lcfg)
    assert init_llama_params(lcfg, device="cpu")["wte"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_kv_cache(lcfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(init_llama_params(lcfg, device="cpu"), lcfg,
                      family="llama")


def test_version_and_device_validation():
    assert isinstance(paddle_tpu_torch.__version__, str)
    with pytest.raises(ValueError):
        resolve_device("meta")

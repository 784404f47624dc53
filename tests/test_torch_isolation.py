"""The port stands alone: no ``jax``, no ``repro``, and no silent CPU fallback.

A fresh interpreter imports every ``repro_torch`` module and runs the
head-count launcher on the CPU at a reduced size; afterwards neither ``jax``
nor any ``repro`` module may be loaded. The same rule is checked statically
over the sources of the package and of ``chip_smoke.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_subprocess_imports_and_runs_without_jax_or_repro():
    mods = list(_modules())
    assert "repro_torch.launch.headcount" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.launch import headcount\n"
        "rc = headcount.main(['--device', 'cpu', '--reduce', '128', '--spec', 'visual'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n"
        "sys.exit(rc if not bad else 3)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout
    assert '"phase": "execute"' in out.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    from repro_torch.core.apps import headcount as hc
    from repro_torch.core.partition_torch import q_min
    from repro_torch.kernels.conv_window.ops import score_windows

    g = hc.build_graph(hc.VISUAL.reduced(128))
    with pytest.raises(RuntimeError, match="cuda"):
        q_min(g, hc.paper_cost_model())  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        score_windows(torch.zeros(1, 12, 12), hc.cnn_weights(0), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        hc.build_graph(hc.VISUAL.reduced(128), with_fns=True)


def test_chip_smoke_refuses_to_run_here(tmp_path):
    """Without a card — and alone in a directory — it exits nonzero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, timeout=300, cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

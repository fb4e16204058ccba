"""The port stands alone: no module under ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax``, ``jaxlib`` or the reference package
``repro`` (``repro_torch`` is allowed), and importing the serving core, the
speculative decoding package, the filling runtime and the train step pulls
no JAX into a fresh interpreter."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_walk_covers_the_port():
    assert len(FILES) > 10
    assert ROOT / "src" / "repro_torch" / "serving" / "core.py" in FILES
    for mod in ("spec/loop.py", "spec/tree.py", "spec/proposers/ngram.py",
                "kernels/paged_tree_verify_attention.py", "kernels/decode_attention.py"):
        assert ROOT / "src" / "repro_torch" / mod in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [
        name for name in _imported_modules(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serving_core_import_pulls_no_jax():
    code = (
        "import sys; import repro_torch.serving.core; "
        "import repro_torch.launch.serve; "
        "import repro_torch.spec; import repro_torch.spec.proposers; "
        "import repro_torch.core.filling; import repro_torch.runtime.step; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr

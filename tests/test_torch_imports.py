"""The port stands alone: no module under ``src/repro_torch/``, nor
``chip_smoke.py``, nor the port's card scripts (``scripts/torch_*.py``) and
examples (``examples/torch_*.py``) imports ``jax``, ``jaxlib`` or the
reference package ``repro`` (``repro_torch`` is allowed), and importing
the serving core, the speculative decoding package, the filling runtime,
the train step, the trainer, the train CLI, the gradient compression, the
Mamba1 and MoE models, the dense verify / tree-verify / scan kernels, the
mesh and the sharding rules pulls no JAX into a fresh interpreter."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py"))
         + sorted((ROOT / "examples").glob("torch_*.py")))


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
                "kernels/paged_tree_verify_attention.py", "kernels/decode_attention.py",
                "models/ssm.py", "kernels/verify_attention.py",
                "kernels/tree_verify_attention.py", "kernels/ssm_scan.py",
                "configs/falcon_mamba_7b.py", "models/moe.py",
                "configs/moonshot_v1_16b_a3b.py", "configs/dbrx_132b.py",
                "runtime/trainer.py", "launch/train.py", "optim/compression.py",
                "core/simulator.py", "core/baselines.py", "core/queues.py",
                "core/hardware.py", "launch/mesh.py", "runtime/sharding.py",
                "models/act_sharding.py", "launch/cost.py", "launch/cells.py",
                "launch/dryrun.py", "launch/roofline.py", "kernels/cost.py"):
        assert ROOT / "src" / "repro_torch" / mod in FILES
    assert ROOT / "scripts" / "torch_scan_breakdown.py" in FILES
    assert ROOT / "examples" / "torch_quickstart.py" in FILES
    assert ROOT / "scripts" / "torch_check_chaos.py" in FILES
    assert ROOT / "examples" / "torch_online_serving.py" in FILES
    assert ROOT / "scripts" / "torch_dev_smoke.py" in FILES


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
        "import repro_torch.models.ssm; import repro_torch.kernels.ssm_scan; "
        "import repro_torch.kernels.verify_attention; "
        "import repro_torch.kernels.tree_verify_attention; "
        "import repro_torch.configs.falcon_mamba_7b; "
        "import repro_torch.models.moe; import repro_torch.configs.dbrx_132b; "
        "import repro_torch.runtime.trainer; import repro_torch.launch.train; "
        "import repro_torch.optim.compression; "
        "import repro_torch.core.simulator; import repro_torch.core.baselines; "
        "import repro_torch.launch.mesh; import repro_torch.runtime.sharding; "
        "import repro_torch.models.act_sharding; "
        "import repro_torch.launch.dryrun; import repro_torch.kernels.cost; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr

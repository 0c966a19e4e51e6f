"""The port imports torch and never JAX. Checked in a fresh interpreter,
because this test process already imports JAX (tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "orbit2_tpu_torch",
    "orbit2_tpu_torch.config",
    "orbit2_tpu_torch.registry",
    "orbit2_tpu_torch.data",
    "orbit2_tpu_torch.ops.attention",
    "orbit2_tpu_torch.ops.flash_attention",
    "orbit2_tpu_torch.ops.pos_embed",
    "orbit2_tpu_torch.models",
    "orbit2_tpu_torch.metrics",
    "orbit2_tpu_torch.transforms",
    "orbit2_tpu_torch.training.checkpoint",
    "orbit2_tpu_torch.training.train",
    "orbit2_tpu_torch.utils.loaders",
    "orbit2_tpu_torch.evaluate",
]


def test_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbit2_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

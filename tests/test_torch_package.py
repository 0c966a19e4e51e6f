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
    "orbit2_tpu_torch.ops.attn_probes",
    "orbit2_tpu_torch.ops.dropout",
    "orbit2_tpu_torch.ops.flash_attention",
    "orbit2_tpu_torch.ops.fused_mlp",
    "orbit2_tpu_torch.ops.kernel_prng",
    "orbit2_tpu_torch.ops.pos_embed",
    "orbit2_tpu_torch.ops.quant",
    "orbit2_tpu_torch.models",
    "orbit2_tpu_torch.parallel.mesh",
    "orbit2_tpu_torch.parallel.pipeline",
    "orbit2_tpu_torch.parallel.sharding",
    "orbit2_tpu_torch.parallel.tensor",
    "orbit2_tpu_torch.metrics",
    "orbit2_tpu_torch.transforms",
    "orbit2_tpu_torch.training.checkpoint",
    "orbit2_tpu_torch.training.optim",
    "orbit2_tpu_torch.training.train",
    "orbit2_tpu_torch.training.trainer",
    "orbit2_tpu_torch.utils.image_metrics",
    "orbit2_tpu_torch.utils.inference",
    "orbit2_tpu_torch.utils.loaders",
    "orbit2_tpu_torch.utils.mc_dropout",
    "orbit2_tpu_torch.utils.quantize",
    "orbit2_tpu_torch.utils.visualize",
    "orbit2_tpu_torch.evaluate",
    "orbit2_tpu_torch.finetune",
    "orbit2_tpu_torch.train",
    "orbit2_tpu_torch.visualize",
    "orbit2_tpu_torch.scripts.bench_attn2",
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


def test_library_name_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edited csrc/ header, included directly or through another header,
    renames the library, so a stale build is never loaded."""
    import shutil

    from orbit2_tpu_torch.ops import _nvcc

    for name in ("flash_attn_bwd.cu", "flash_common.cuh", "kernel_prng.cuh"):
        shutil.copy(_nvcc.CSRC_DIR / name, tmp_path / name)
    monkeypatch.setattr(_nvcc, "CSRC_DIR", tmp_path)
    lib = _nvcc.NvccLibrary("flash_attn_bwd.cu")
    assert {p.name for p in lib.sources()} == {"flash_attn_bwd.cu", "flash_common.cuh",
                                               "kernel_prng.cuh"}
    before = lib.path()
    assert lib.path() == before
    with open(tmp_path / "kernel_prng.cuh", "a") as f:
        f.write("// edited\n")
    assert lib.path() != before
    assert lib.path().name.startswith("libflash_attn_bwd_")


def test_port_calls_no_library_attention_or_compiler():
    """The port's kernels are its own: no file of the package calls PyTorch's
    fused attention or torch.compile (chip_smoke.py times SDPA only as a
    yardstick)."""
    import re
    from pathlib import Path

    pattern = re.compile(r"scaled_dot_product_attention|torch\.compile\b|sdpa_kernel")
    root = Path(REPO) / "orbit2_tpu_torch"
    hits = [f"{path.relative_to(REPO)}:{i}" for path in sorted(root.rglob("*"))
            if path.suffix in (".py", ".cu", ".cuh") and "_build" not in path.parts
            for i, line in enumerate(path.read_text().splitlines(), 1) if pattern.search(line)]
    assert not hits, hits

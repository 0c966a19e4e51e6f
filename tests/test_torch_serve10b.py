"""The 10B config (configs/interm_10b.yaml) on the port's serving path.

CPU, against the JAX package (imported inside the tests, so the `cuda` cases
below run on a machine without it):
  * the port's meta-device build of interm_10b.yaml at 48 x 96 tiles (ERA5's
    1.0 deg grid, 180 x 360, under the config's div 4 / overlap 3) has JAX's
    parameter count and every tensor's shape, key for key; JAX's module
    without the loaders' learn_pos_emb=True keeps the fixed sin-cos pos_embed
    out of its params, exactly 1,152 x 8,192 fewer;
  * both packages refuse the config's own ERA5_1 grid (32 x 64 -> 11 x 22
    tiles, odd for patch 2) with the same ValueError and accept 180 x 360;
  * a tiny 10B-shaped config (23 -> 3 variables, embed 512, 2 heads: d 256,
    depth 3, decoder depth 2, tanh GELU, div 4 / overlap 3 on 36 x 72): the
    Evaluator, built on the meta device and filled unit by unit, matches JAX
    Trainer.test on the same (perturbed) weights, fp32 metrics rtol 1e-4 and
    w8a8 rtol 1e-3;
  * the serving modes: a bf16-only Evaluator keeps no fp32 tensor and
    refuses w8a8; the twin quantized unit by unit at construction equals
    utils/quantize.py::w8a8_twin of the whole fp32 state, bit for bit; a
    unit-by-unit draw equals the whole model's draw at construction;
  * the lazy npz (NpzState) gives the same tensors and reads one member per
    key a merge takes, and one header pass at its opening; the memory
    telemetry is None on the CPU.

CUDA (marker `cuda`, skipped without a card): K1 at the 10B serving shape
(B16, N1152, H32, d256), with and without dropout, against its plain version
on the first and last batch elements; K5 at the MLP hidden's [18432, 32768]
bit for bit; the memory telemetry on the card:
`python -m pytest --noconftest -m cuda tests/test_torch_serve10b.py`.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from orbit2_tpu_torch.config import load_config
from orbit2_tpu_torch.evaluate import Evaluator, check_tiling, make_data_module, model_kwargs
from orbit2_tpu_torch.ops.quant import quantize_weight
from orbit2_tpu_torch.training import checkpoint as ck
from orbit2_tpu_torch.utils.loaders import load_architecture
from orbit2_tpu_torch.utils.memory import device_memory_stats, log_memory
from orbit2_tpu_torch.utils.quantize import w8a8_twin

CONFIG_10B = Path(__file__).resolve().parents[1] / "configs" / "interm_10b.yaml"
MAG = 4


def write_era5(root: Path, in_vars, out_vars, low, t=1, seed=0):
    """The tests/conftest.py layout at `low` -> MAG x finer: a test split of
    t fields; every split's climatology."""
    rng = np.random.default_rng(seed)

    def field(v, h, w):
        if v == "total_precipitation_24hr":
            return rng.gamma(0.3, 0.004, size=(t, 1, h, w))
        if v in ("land_sea_mask", "landcover"):
            return rng.integers(0, 2, size=(t, 1, h, w)).astype(np.float64)
        return rng.normal(280, 10, size=(t, 1, h, w))

    for base, (h, w), variables in ((root / "low", low, in_vars),
                                    (root / "high", (low[0] * MAG, low[1] * MAG), out_vars)):
        for split in ("train", "val", "test"):
            (base / split).mkdir(parents=True)
            if split == "test":
                np.savez(base / split / "shard_0.npz",
                         **{v: field(v, h, w).astype(np.float32) for v in variables})
            np.savez(base / split / "climatology.npz",
                     **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32)
                        for v in variables})
        np.save(base / "lat.npy", np.linspace(-88, 88, h).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, w).astype(np.float32))
        np.savez(base / "normalize_mean.npz", **{v: np.array([280.0], np.float32) for v in variables})
        np.savez(base / "normalize_std.npz", **{v: np.array([10.0], np.float32) for v in variables})
    return str(root / "low"), str(root / "high")


def raw_10b(root: Path, key: str, low, model=None, trainer=None, t=1):
    """configs/interm_10b.yaml with its mesh cut to one device and ERA5_1's
    23 -> 3 variables under `key` on a synthetic grid at `low`."""
    raw = yaml.safe_load(CONFIG_10B.read_text())
    data = raw["data"]
    in_vars, out_vars = data["dict_in_variables"]["ERA5_1"], data["dict_out_variables"]["ERA5_1"]
    lo, hi = write_era5(root, in_vars, out_vars, low, t=t)
    data["low_res_dir"], data["high_res_dir"] = {key: lo}, {key: hi}
    data["dict_in_variables"], data["dict_out_variables"] = {key: in_vars}, {key: out_vars}
    raw["parallelism"] = {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1, "seq_par": 1}
    raw["trainer"].update({"batch_size": 16, "num_workers": 0, **(trainer or {})})
    raw["model"].update(model or {})
    return raw


@pytest.fixture(scope="module")
def grid_1deg(tmp_path_factory):
    """interm_10b.yaml on a synthetic ERA5 1.0 deg field (180 x 360 -> 720 x 1440)."""
    return raw_10b(tmp_path_factory.mktemp("era5_1deg"), "ERA5_2", (180, 360))


def jax_trainer_model(raw, tmp_path):
    """(JAX Trainer, its data module of the first key, its phase model), as
    Trainer.test builds them: the loaders' ResSlimViT after the tile check."""
    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    trainer = JaxTrainer(jax_load_config(copy.deepcopy(raw)), checkpoint_dir=str(tmp_path / "ck"))
    key = next(iter(raw["data"]["low_res_dir"]))
    dm = trainer._make_data_module(key)
    dm.setup("test")
    trainer._build_model(dm, key)
    return trainer, dm, trainer._phase_model(dm, key)


def jax_abstract_params(phase_model, dm):
    import jax
    import jax.numpy as jnp

    in_shape, _ = dm.get_data_dims()
    in_vars, out_vars = dm.get_data_variables()
    dummy = jnp.zeros((2,) + tuple(in_shape[1:]), jnp.float32)
    return jax.eval_shape(lambda r: phase_model.init(
        {"params": r}, dummy, tuple(in_vars), tuple(out_vars), deterministic=True),
        jax.random.PRNGKey(0))


def meta_model(cfg, dm, quant="none"):
    with torch.device("meta"):
        model = load_architecture(dm, cfg.model.preset,
                                  **dict(model_kwargs(cfg), generator=None, quant=quant))
    in_shape, _ = dm.get_data_dims()
    in_vars, out_vars = dm.get_data_variables()
    key = next(iter(cfg.data.low_res_dir))
    return model.for_phase(cfg.data.spatial_resolution[key], tuple(in_shape[2:]),
                           len(in_vars), len(out_vars))


def test_10b_parameters_match_jax_key_for_key(grid_1deg, tmp_path, monkeypatch):
    import dataclasses

    import jax

    cfg = load_config(copy.deepcopy(grid_1deg))
    dm = make_data_module(cfg, "ERA5_2", cfg.tiling.effective_div,
                          cfg.tiling.effective_overlap, "test")
    in_shape, _ = dm.get_data_dims()
    assert tuple(in_shape[1:]) == (23, 48, 96)  # 24 x 48 = 1,152 tokens at patch 2
    port = meta_model(cfg, dm).state_dict()
    n_port = sum(t.numel() for t in port.values())
    assert n_port == 9_408_639_363

    _, jdm, phase_model = jax_trainer_model(grid_1deg, tmp_path)
    params = jax_abstract_params(phase_model, jdm)["params"]
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params)) == n_port
    fixed = jax_abstract_params(dataclasses.replace(phase_model, learn_pos_emb=False), jdm)
    n_fixed = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(fixed["params"]))
    assert n_port - n_fixed == 1152 * 8192 == int(np.prod(fixed["fixed"]["pos_embed"].shape))

    # the export's key map on zero-byte arrays: shapes only, nothing allocated
    empty = jax.tree.map(lambda a: np.zeros(a.shape, np.dtype([])), params)
    monkeypatch.setattr(ck.torch, "from_numpy", lambda a: torch.empty(a.shape, device="meta"))
    want = ck.state_dict_from_jax_params(empty, patch_size=2)
    assert sorted(want) == sorted(port)
    for k, t in port.items():
        assert tuple(want[k].shape) == tuple(t.shape), k


def test_10b_config_grid_refused_by_both_packages_and_1deg_accepted(grid_1deg, tmp_path):
    """ERA5_1 at 5.625 deg (32 x 64) cuts 11 x 22 tiles under div 4 /
    overlap 3 (halo left 2, right 4, top 1, bottom 2): odd for patch 2."""
    from orbit2_tpu.config import load_config as jax_load_config
    from orbit2_tpu.training.trainer import Trainer as JaxTrainer

    raw = raw_10b(tmp_path / "era5_5625", "ERA5_1", (32, 64),
                  model={"embed_dim": 64, "num_heads": 1, "depth": 1, "decoder_depth": 1})
    with pytest.raises(ValueError) as want:
        JaxTrainer(jax_load_config(copy.deepcopy(raw)),
                   checkpoint_dir=str(tmp_path / "ck")).test(max_batches=1)
    with pytest.raises(ValueError, match=r"tile shape \(11, 22\).*increase tiling.overlap by 1") \
            as got:
        Evaluator(load_config(raw), "cpu")
    assert str(got.value) == str(want.value)

    cfg = load_config(copy.deepcopy(grid_1deg))
    check_tiling(cfg, make_data_module(cfg, "ERA5_2", 4, 3, "test"))
    trainer, jdm, _ = jax_trainer_model(grid_1deg, tmp_path)
    trainer._check_tiling(jdm)


TINY_10B = {"embed_dim": 512, "num_heads": 2, "depth": 3, "decoder_depth": 2}


@pytest.fixture(scope="module")
def tiny_10b(tmp_path_factory):
    """A 10B-shaped config cut to a tiny width: ERA5_1's 23 -> 3 variables,
    d 256, tanh GELU, div 4 / overlap 3 on 36 x 72 (12 x 24 tiles), 4 tiles a
    batch, fp32; 2 test fields."""
    return raw_10b(tmp_path_factory.mktemp("tiny_10b"), "ERA5_2", (36, 72), model=TINY_10B,
                   trainer={"batch_size": 4, "data_type": "float32"}, t=2)


@pytest.fixture(scope="module")
def jax_tiny_10b(tiny_10b, tmp_path_factory):
    """The JAX Trainer's weights for tiny_10b, perturbed by noise of std
    0.3 / sqrt(fan_in / 32) so that the trunk moves the metrics (at init scale
    the CNN residual path dominates them), and its Trainer.test metrics of 2
    batches in fp32 and w8a8."""
    import jax

    trainer, _, _ = jax_trainer_model(tiny_10b, tmp_path_factory.mktemp("ck"))
    trainer.test(max_batches=1)  # draws the params
    rng = np.random.default_rng(1)

    def perturb(a):
        a = np.asarray(a)
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        return a + (0.3 * min(1.0, (32 / fan_in) ** 0.5)
                    * rng.normal(size=a.shape)).astype(np.float32)

    trainer.params = jax.tree.map(perturb, trainer.params)
    want = {quant: trainer.test(max_batches=2, quant=quant) for quant in ("none", "w8a8")}
    return ck.state_dict_from_jax_params(trainer.params, patch_size=2), want


@pytest.mark.parametrize("quant,rtol", [("none", 1e-4), ("w8a8", 1e-3)], ids=["fp32", "w8a8"])
def test_tiny_10b_evaluator_matches_jax_trainer_test(tiny_10b, jax_tiny_10b, quant, rtol):
    state, want = jax_tiny_10b
    ev = Evaluator(load_config(copy.deepcopy(tiny_10b)), "cpu", state_dict=state,
                   quant_modes=(quant,))
    in_shape, _ = ev.data_module.get_data_dims()
    assert tuple(in_shape[1:]) == (23, 12, 24)
    got = ev.test(max_batches=2, quant=quant)
    assert list(got) == list(want[quant]) and len(got) == 12
    for k, v in want[quant].items():
        np.testing.assert_allclose(got[k], float(v), rtol=rtol, atol=1e-6, err_msg=k)
    if quant != "none":
        # the int8 trunk moves the metrics further than the packages differ
        worst = lambda m: max(abs(m[k] - float(want[quant][k])) / abs(float(want[quant][k]))
                              for k in m)
        assert worst(ev.test(max_batches=2)) > 10 * worst(got)


def bf16(raw):
    raw = copy.deepcopy(raw)
    raw["trainer"]["data_type"] = "bfloat16"
    return load_config(raw)


def test_bf16_only_evaluator_keeps_no_fp32_tensor_and_refuses_w8a8(tiny_10b):
    ev = Evaluator(bf16(tiny_10b), "cpu", quant_modes=("none",))
    assert ev._twins == {}
    assert {t.dtype for t in ev.model.state_dict().values()} == {torch.bfloat16}
    assert np.isfinite(list(ev.test(max_batches=1).values())).all()
    with pytest.raises(ValueError, match="quant_modes"):
        ev.test(max_batches=1, quant="w8a8")
    with pytest.raises(ValueError, match="unknown quant_modes"):
        Evaluator(bf16(tiny_10b), "cpu", quant_modes=("w4a4",))


@pytest.mark.parametrize("source", ["drawn", "state_dict"])
def test_twin_quantized_at_construction_equals_the_whole_state_twin(tiny_10b, jax_tiny_10b,
                                                                    source):
    """The twin quantized unit by unit from the fp32 tensors as they are
    filled equals w8a8_twin of the whole fp32 state dict, bit for bit; the
    default Evaluator builds it too."""
    state = jax_tiny_10b[0] if source == "state_dict" else None
    fp32 = Evaluator(load_config(copy.deepcopy(tiny_10b)), "cpu", state_dict=state,
                     quant_modes=("none",)).model.state_dict()
    assert {t.dtype for t in fp32.values()} == {torch.float32}
    eager = Evaluator(bf16(tiny_10b), "cpu", state_dict=state, quant_modes=("none", "w8a8"))
    default = Evaluator(bf16(tiny_10b), "cpu", state_dict=state)
    assert default.quant_modes == ("none", "w8a8")
    want = w8a8_twin(eager._architecture("w8a8"), fp32, "cpu").state_dict()
    for ev in (eager, default):
        got = ev.serving_model("w8a8").state_dict()
        assert ev.serving_model("w8a8") is ev.serving_model("w8a8")
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    got = eager.serving_model("w8a8").state_dict()
    w = fp32["blocks.2.mlp.fc1.weight"]
    assert torch.equal(got["blocks.2.mlp.fc1.weight_q"], quantize_weight(w)[0])
    assert torch.equal(eager.model.state_dict()["blocks.0.norm1.weight"],
                       got["blocks.0.norm1.weight"])


@pytest.mark.parametrize("preset", ["res_slimvit", "resnet", "unet", "vit"])
def test_unit_by_unit_draw_equals_the_models_draw(tiny_10b, preset, monkeypatch):
    """The Evaluator's meta build filled unit by unit from the host
    generator holds the weights the whole model draws at construction: the
    ResSlimViT's units, and each model-hub preset's one unit, BatchNorm
    buffers included (the Unet at a small width, two levels with an
    AttentionBlock: every kind of its modules draws)."""
    from orbit2_tpu_torch.models.unet import Unet
    from orbit2_tpu_torch.utils import loaders

    small = dict(hidden_channels=8, ch_mults=(1, 2), is_attn=(False, True), n_blocks=1)
    monkeypatch.setattr(loaders, "Unet", lambda *a, **kw: Unet(*a, **{**kw, **small}))
    raw = copy.deepcopy(tiny_10b)
    raw["model"]["preset"] = preset
    cfg = load_config(raw)
    ev = Evaluator(cfg, "cpu")
    want = load_architecture(ev.data_module, cfg.model.preset, **model_kwargs(cfg)).state_dict()
    got = ev.model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_lazy_npz_reads_member_by_member(tiny_10b, tmp_path, monkeypatch):
    state = Evaluator(load_config(copy.deepcopy(tiny_10b)), "cpu").model.state_dict()
    path = tmp_path / "state.npz"
    np.savez(path, **{k: v.numpy() for k, v in state.items()})
    lazy = ck.load_state_npz(str(path))
    with np.load(path) as raw:
        eager = {k: torch.from_numpy(raw[k]) for k in raw.files}
    assert list(lazy) == list(eager) and len(lazy) == len(eager)
    for k, v in eager.items():
        assert lazy.shape(k) == tuple(v.shape) and torch.equal(lazy[k], v), k

    opened = []
    load = np.load
    with monkeypatch.context() as m:
        m.setattr(ck.np, "load", lambda *a, **kw: opened.append(a[0]) or load(*a, **kw))
        assert lazy.shape("var_agg.q.weight") == tuple(state["var_agg.q.weight"].shape)
    assert opened == []  # the headers were read when the file was opened
    reads = []
    get = ck.NpzState.__getitem__
    monkeypatch.setattr(ck.NpzState, "__getitem__", lambda self, k: reads.append(k) or get(self, k))
    merged, report = ck.load_pretrained_params(state, lazy, 2, keys=["var_agg.q.weight"])
    assert reads == ["var_agg.q.weight"] and list(merged) == ["var_agg.q.weight"]
    assert len(report["used"]) == len(state)
    ev = Evaluator(load_config(copy.deepcopy(tiny_10b)), "cpu", state_dict=lazy)
    assert sorted(reads[1:]) == sorted(state)  # each member read once
    for k, v in ev.model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_memory_stats_are_none_on_the_cpu():
    class Logger:
        def log(self, event, **fields):
            raise AssertionError("nothing to log on the CPU")

    assert device_memory_stats("cpu") is None
    assert log_memory(Logger(), device="cpu") is None


# ---- on the card -------------------------------------------------------------

# the 10B serving batch's attention: 16 tiles of 24 x 48 tokens, 32 heads of 256
B, N, H, D = 16, 1152, 32, 256
ROWS = (0, B - 1)
O_TOL = dict(atol=1e-2, rtol=1e-2)
LSE_ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
def test_k1_at_the_10b_serving_shape(cuda, rate):
    from orbit2_tpu_torch.ops.flash_attention import (
        FLASH_FWD, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(B, N, H, D, generator=gen, device=cuda).bfloat16() for _ in range(3))
    seed = 2 ** 40 + 3
    before = FLASH_FWD.launches
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    for b in ROWS:
        one = slice(b, b + 1)
        mult = (keep_mult(seed, N, N, rate, streams=H, device=cuda, first_stream=b * H)
                if rate > 0.0 else None)
        want_o, want_lse = flash_attention_reference(q[one], k[one], v[one], None, mult)
        torch.testing.assert_close(o[one], want_o, **O_TOL)
        torch.testing.assert_close(lse[b * H:(b + 1) * H], want_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.cuda
def test_k5_at_the_10b_mlp_hidden_bit_for_bit(cuda):
    from orbit2_tpu_torch.ops.dropout import FUSED_DROPOUT, apply_dropout, dropout_reference
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    rows, cols, seed = B * N, 4 * 8192, 2 ** 40 + 5
    x = torch.randn(rows, cols, generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).bfloat16()
    before = FUSED_DROPOUT.launches
    out = apply_dropout(x, seed, 0.1)
    torch.cuda.synchronize()
    assert FUSED_DROPOUT.launches == before + 1
    assert torch.equal(out, dropout_reference(x, keep_mult(seed, rows, cols, 0.1, device=cuda)))


@pytest.mark.cuda
def test_memory_stats_on_the_card(cuda):
    x = torch.empty(1 << 28, dtype=torch.uint8, device=cuda)
    stats = device_memory_stats(cuda)
    assert stats["bytes_in_use"] >= x.numel()
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] > stats["peak_bytes_in_use"]
    assert stats["bytes_reserved"] >= stats["bytes_in_use"]
    assert device_memory_stats() == device_memory_stats(cuda)

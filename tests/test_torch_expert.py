"""The expert axis of the port's device mesh, against the JAX package.

The multi-process cases read tests/test_torch_seq.py's one launch of
tests/torch_mesh_worker.py (`seqexpert`): a tiny MoE trunk (4 experts in
each Block, head dim 64) on 4 gloo ranks on the CPU, from the JAX Trainer's
initial parameters:
  * one train step at expert 2 x fsdp 2 and at expert 2 x tensor 2 (an MoE
    trunk under tensor parallelism): the loss and every gradient,
    router_kernel's included, against JAX's one-device step (atol 1e-5 /
    rtol 1e-4);
  * Trainer.fit at expert 2 x fsdp 2 (over a train split that repeats one
    field, as test_torch_seq.py says why) and at expert 2 x tensor 2 (no
    data split: the synthetic split as it is) against JAX's Trainer.fit on
    the same meshes (rtol 2e-4);
  * the checkpoint rank 0 wrote on the expert mesh resumes on one process,
    parameters and moments bit for bit;
  * with dropout and drop-path, the dense parameters stay bit-equal on both
    expert ranks.
Single-process cases: the rank's experts and the expert x tensor split of
the stacks (parallel/sharding.py::spec_for, JAX's rules), and the scope
checks that now take configs/interm_1b_moe.yaml's mesh at world 8.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as worker  # noqa: E402
from test_torch_seq import TOL, seqexpert  # noqa: E402,F401  (the shared launch)

from orbit2_tpu_torch.config import ConfigError, load_config  # noqa: E402
from orbit2_tpu_torch.evaluate import check_mesh, check_scope  # noqa: E402
from orbit2_tpu_torch.models import ResSlimViT  # noqa: E402
from orbit2_tpu_torch.parallel.sharding import check_shardable, spec_for  # noqa: E402
from orbit2_tpu_torch.train import scale_parallelism  # noqa: E402
from orbit2_tpu_torch.training.trainer import Trainer  # noqa: E402

CONFIG_MOE = os.path.join(ROOT, "configs", "interm_1b_moe.yaml")
MESHES = ["moe_ep_fsdp", "moe_ep_tp"]


@pytest.mark.parametrize("mesh", MESHES)
def test_expert_train_step_matches_jax(seqexpert, mesh):
    got, want = seqexpert["port"], seqexpert["jax"]
    np.testing.assert_allclose(float(got[f"step/{mesh}/loss"]), float(want["step/moe/loss"]),
                               **TOL)
    grads = {k.rsplit("/grad/", 1)[1] for k in got.files if k.startswith(f"step/{mesh}/grad/")}
    assert grads == {k.rsplit("/grad/", 1)[1] for k in want.files
                     if k.startswith("step/moe/grad/")}
    assert any(k.endswith("moe_mlp.router_kernel") for k in grads)
    for k in grads:
        np.testing.assert_allclose(got[f"step/{mesh}/grad/{k}"], want[f"step/moe/grad/{k}"],
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_expert_trainer_fit_matches_jax(seqexpert, mesh):
    records = seqexpert["reports"][0][f"fit/{mesh}"]
    got = [r["loss"] for r in records]
    assert len(got) == worker.FIT["max_epochs"] and all(r["batches"] == 1 for r in records)
    np.testing.assert_allclose(got, seqexpert["jax_fit"][mesh], rtol=2e-4)
    assert all([r["loss"] for r in rep[f"fit/{mesh}"]] == got for rep in seqexpert["reports"])


def test_expert_checkpoint_resumes_on_one_process_bit_for_bit(seqexpert):
    """Rank 0 gathered the expert stacks whole into each epoch's checkpoint;
    a Trainer on one process resumes the newest, parameters and moments
    equal to the mesh's at the end of its fit."""
    root = seqexpert["root"]
    cfg = scale_parallelism(load_config(str(root / "moe_ep_fsdp.yaml")), 1)
    assert (cfg.parallelism.fsdp, cfg.parallelism.expert_par) == (1, 2)
    cfg.parallelism.expert_par = 1  # the one process holds every expert
    ck = root / "out" / "ck"
    assert sorted(os.listdir(ck)) == [f"epoch_{e}" for e in range(worker.FIT["max_epochs"])]
    trainer = Trainer(cfg, "cpu", checkpoint_dir=str(ck))
    assert trainer._start(trainer.data_module("SYNTH")) == worker.FIT["max_epochs"]
    got, port = trainer.model.state_dict(), seqexpert["port"]
    want = {k.rsplit("/param/", 1)[1]: port[k] for k in port.files
            if k.startswith("fit/moe_ep_fsdp/param/")}
    assert set(got) == set(want) and any(".moe_mlp.wi" in k for k in want)
    for k, t in got.items():
        assert torch.equal(t, torch.from_numpy(want[k])), k
    opt = trainer.optimizer.state_dict()
    for key in ("mu", "nu"):
        for k, t in opt[key].items():
            assert torch.equal(t, torch.from_numpy(port[f"fit/moe_ep_fsdp/{key}/{k}"])), (key, k)


def test_dense_parameters_stay_bit_equal_across_expert_ranks(seqexpert):
    """expert 2 x fsdp 2, dropout and drop-path 0.1, two steps: every
    parameter but the expert stacks is the same on both expert ranks."""
    for report in seqexpert["reports"]:
        r = report["replicas/expert2_fsdp2"]
        checked, equal = r["checked"]["expert"]
        assert checked > 0 and equal == checked, r
        assert all(np.isfinite(r["losses"]))


def test_expert_stacks_follow_jax_rules():
    mesh = {"expert": 2, "fsdp": 2, "tensor": 2}
    assert spec_for("blocks.1.moe_mlp.wi", (4, 64, 256), mesh) == ("expert", "fsdp", "tensor")
    assert spec_for("blocks.1.moe_mlp.bi", (4, 256), mesh) == ("expert", "tensor")
    assert spec_for("blocks.1.moe_mlp.wo", (4, 256, 64), mesh) == ("expert", "tensor", "fsdp")
    assert spec_for("blocks.1.moe_mlp.bo", (4, 64), mesh) == ("expert", None)
    assert spec_for("blocks.1.moe_mlp.router_kernel", (64, 4), mesh) == (None, None)


def test_1b_moe_config_trains_at_its_shipped_mesh_at_world_8():
    """interm_1b_moe.yaml ships fsdp 2 x expert_par 4: at world 8 the
    scale-down keeps it, and the mesh, scope and sharding checks take it
    (they refused expert_par > 1 and an MoE trunk under tensor_par before)."""
    cfg = scale_parallelism(load_config(CONFIG_MOE), 8)
    par = cfg.parallelism
    assert (par.fsdp, par.expert_par, par.world_size) == (2, 4, 8)
    check_mesh(cfg, 8)
    check_scope(cfg)
    m = cfg.model
    with torch.device("meta"):
        model = ResSlimViT(cfg.data.default_vars, (16, 32), len(cfg.data.default_vars), 3,
                           embed_dim=m.embed_dim, depth=m.depth, num_heads=m.num_heads,
                           moe_experts=m.moe_experts, moe_every=m.moe_every)
    check_shardable(model, {"fsdp": 2, "expert": 4})
    check_shardable(model, {"expert": 2, "tensor": 2})
    with pytest.raises(ValueError, match="must divide the 8 experts"):
        check_shardable(model, {"expert": 3})


@pytest.mark.parametrize("package", ["jax", "port"])
def test_expert_config_refusals_match_jax(package, synth_dataset):
    from test_torch_seq import raw_config

    def raw(parallelism, model):
        return raw_config(synth_dataset["low"], synth_dataset["high"], synth_dataset["in_vars"],
                          synth_dataset["out_vars"], parallelism, model)

    cases = [(raw({"expert_par": 2}, {}), "needs model.moe_experts"),
             (raw({"expert_par": 3}, worker.MOE_MODEL), "divisible by parallelism.expert_par")]
    if package == "jax":
        from orbit2_tpu.config import ConfigError as JaxConfigError
        from orbit2_tpu.config import load_config as jax_load_config
        load, error = jax_load_config, JaxConfigError
    else:
        load, error = load_config, ConfigError
    for config, match in cases:
        with pytest.raises(error, match=match):
            load(config)

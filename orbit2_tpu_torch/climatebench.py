"""ClimateBench climate-projection driver on one device: the port's
counterpart of examples/climatebench.py (reference
experiments/climate_projection/climatebench.py:16-134).

Usage: python -m orbit2_tpu_torch.climatebench CLIMATEBENCH_DIR \
           {resnet,unet,vit} {tas,diurnal_temperature_range,pr,pr90} \
           [--max_epochs 50] [--patience 10] [--batch_size 16] [--device cuda]

Trains resnet / unet / vit (MODEL_KWARGS, the reference experiment's
overrides) on the ClimateBench forcings (CO2, SO2, CH4, BC as sliding
history windows of 10 years) for one output variable with AdamW (lr 5e-4,
weight decay 1e-5, betas (0.9, 0.99)) and the linear-warmup-cosine schedule
(5 warm-up epochs from 1e-8, eta_min 1e-8), stepped once an epoch;
validates after each epoch and stops early once val/mse:aggregate has not
improved for `patience` epochs; keeps the best parameters (and BatchNorm
running averages), and reports the ClimateBench NRMSE trio (lat_nrmses,
lat_nrmseg, lat_nrmse) over the 2080-2100 test window with them. Partial
train batches are skipped, as the JAX driver skips them.

The netCDF reader (data/climatebench.py::load_x_y) needs xarray, as in JAX;
`ClimateBenchDataModule(_arrays=...)` feeds arrays instead. The models run
in fp32, as the JAX driver's do; the ViT's head dim (128 / 4 = 32) is not
one the flash kernels take, so its attention is the plain softmax path
(ops/attention.py), as JAX declines it to XLA; the dropout sites are the
fused dropout kernel (K5).
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

import torch

from orbit2_tpu_torch.training.optim import make_lr_scheduler, make_optimizer, set_learning_rate
from orbit2_tpu_torch.training.train import evaluate_batch, make_eval_step, make_train_step

log = logging.getLogger("orbit2_tpu_torch")

# Per-model overrides, verbatim from the reference experiment
# (experiments/climate_projection/climatebench.py:45-72).
MODEL_KWARGS = {
    "resnet": dict(in_channels=4, out_channels=1, history=10, n_blocks=28),
    "unet": dict(in_channels=4, out_channels=1, history=10,
                 ch_mults=(1, 2, 2), is_attn=(False, False, False)),
    "vit": dict(img_size=(32, 64), in_channels=4, out_channels=1, history=10,
                patch_size=2, embed_dim=128, depth=8, decoder_depth=2,
                learn_pos_emb=True, num_heads=4),
}
DROPOUT_SEED_OFFSET = 17
DROP_PATH_SEED_OFFSET = 18


def build_model(name: str, overrides=None, generator: Optional[torch.Generator] = None):
    from orbit2_tpu_torch.models.resnet import ResNet
    from orbit2_tpu_torch.models.unet import Unet
    from orbit2_tpu_torch.models.vit import VisionTransformer

    kwargs = dict(MODEL_KWARGS[name])
    kwargs.update(overrides or {})
    cls = {"resnet": ResNet, "unet": Unet, "vit": VisionTransformer}[name]
    return cls(**kwargs, generator=generator)


def run(dm, model_name: str, max_epochs: int = 50, patience: int = 10, model_overrides=None,
        lr: float = 5e-4, device="cuda", state_dict=None, seed: int = 0,
        history: Optional[List[dict]] = None):
    """Train + early stop + test; returns (best_val, test_metrics). The
    weights are drawn from `seed`, or loaded strictly from `state_dict`
    (reference layout, e.g. training/checkpoint.py::state_dict_from_jax_params).
    `history`, a list, receives one record per epoch: {epoch, loss, steps,
    val, lr}."""
    from orbit2_tpu_torch.utils.loaders import load_climatebench_module

    device = torch.device(device)
    model = build_model(model_name, model_overrides, torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.to(device)
    (model, train_loss, val_losses, test_losses, _, val_transforms,
     test_transforms) = load_climatebench_module(data_module=dm, model=model)
    in_vars, out_vars = dm.get_data_variables()

    # optimizer and schedule from the reference experiment (:73-79)
    opt = make_optimizer("adamw", {"lr": lr, "weight_decay": 1e-5, "betas": (0.9, 0.99)},
                         model.named_parameters())
    schedule = make_lr_scheduler("linear-warmup-cosine-annealing", {
        "lr": lr, "warmup_epochs": 5, "max_epochs": max_epochs, "warmup_start_lr": 1e-8,
        "eta_min": 1e-8})
    step = make_train_step(model, train_loss, None, opt, in_vars, out_vars)
    eval_step = make_eval_step(model, in_vars, out_vars)
    dropout_gen = torch.Generator().manual_seed(seed + DROPOUT_SEED_OFFSET)
    drop_path_gen = torch.Generator().manual_seed(seed + DROP_PATH_SEED_OFFSET)

    def put(a):
        return torch.from_numpy(a).to(device)

    def evaluate(loader, stage, losses, transforms):
        sums, n = {}, 0
        for x, y, *_ in loader:
            x, y = put(x), put(y)
            d = evaluate_batch(eval_step(x, y), y, stage, losses, transforms, out_vars)
            values = torch.stack(list(d.values())).tolist()  # one sync per batch
            for k, v in zip(d, values):
                sums[k] = sums.get(k, 0.0) + v * x.shape[0]
            n += x.shape[0]
        return {k: v / max(1, n) for k, v in sums.items()}

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best_val, best, bad_epochs = float("inf"), snapshot(), 0
    monitor = f"val/{getattr(val_losses[0], 'name', 'mse')}:aggregate"
    for epoch in range(max_epochs):
        set_learning_rate(opt, schedule(epoch))
        losses = []
        for x, y, *_ in dm.train_dataloader():
            if x.shape[0] != dm.batch_size:
                continue  # torch drop_last, as the JAX driver keeps one jit shape
            losses.append(step(put(x), put(y), dropout_gen, drop_path_gen))
        epoch_loss = torch.stack(losses).sum().item() if losses else 0.0
        val = evaluate(dm.val_dataloader(), "val", val_losses, val_transforms)
        val_metric = val[monitor]
        log.info("epoch %d train=%.5f %s=%.5f lr=%.2e", epoch, epoch_loss / max(1, len(losses)),
                 monitor, val_metric, schedule(epoch))
        if history is not None:
            history.append({"epoch": epoch, "loss": epoch_loss / max(1, len(losses)),
                            "steps": len(losses), "val": val_metric, "lr": schedule(epoch)})
        if val_metric < best_val:
            best_val, best, bad_epochs = val_metric, snapshot(), 0
        else:
            bad_epochs += 1
            # Lightning EarlyStopping stops when wait_count >= patience
            if bad_epochs >= patience:
                log.info("early stop at epoch %d (best %s=%.5f)", epoch, monitor, best_val)
                break

    model.load_state_dict(best)  # trainer.test(ckpt_path="best")
    test = evaluate(dm.test_dataloader(), "test", test_losses, test_transforms)
    for k, v in sorted(test.items()):
        log.info("%s = %.6f", k, v)
    return best_val, test


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("climatebench_dir")
    p.add_argument("model", choices=["resnet", "unet", "vit"])
    p.add_argument("variable", choices=["tas", "diurnal_temperature_range", "pr", "pr90"],
                   help="The variable to predict.")
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from orbit2_tpu_torch.data.climatebench import ClimateBenchDataModule

    dm = ClimateBenchDataModule(args.climatebench_dir, variables=("CO2", "SO2", "CH4", "BC"),
                                out_variables=args.variable, train_ratio=0.9, history=10,
                                batch_size=args.batch_size)
    return run(dm, args.model, max_epochs=args.max_epochs, patience=args.patience,
               device=args.device)


if __name__ == "__main__":
    main()

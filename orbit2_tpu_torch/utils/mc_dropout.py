"""MC-dropout ensemble inference (counterpart of
orbit2_tpu/utils/mc_dropout.py; reference utils/mc_dropout.py:4-19).

The reference flips ONLY its Dropout modules to train mode during eval
(`enable_dropout`), so DropPath (stochastic depth) stays off. Here that
selectivity falls out of the generators: the model runs in train mode with a
`dropout` generator only, and DropPath without its own generator is inert
(models/components/blocks.py), so the ensemble samples the reference's
distribution. On the card the dropout sites are the kernels: the flash
forward with dropout and the fused dropout (in an MoE Block, on the
attention's projection and the MoE output: its experts' hidden has none).

On a device mesh (a model sharded by parallel/sharding.py::shard_model, as
the Evaluator serves it there) every rank calls it, each with its data
rank's batch, with generators seeded alike: each member's seeds are then
folded with the rank's coordinates, as in training, so the data ranks draw
the masks of their slices of one global batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def get_monte_carlo_predictions(
    model: torch.nn.Module,
    x: torch.Tensor,
    in_variables: Sequence[str],
    out_variables: Sequence[str],
    n_samples: int = 10,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns [n_samples, B, C_out, H, W] of stochastic forward passes, the
    dropout seeds drawn in turn from `generator` (default: seeded 0)."""
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    was_training = model.training
    model.train()
    try:
        with torch.no_grad():
            return torch.stack([model(x, in_variables, out_variables, dropout_gen=generator)
                                for _ in range(n_samples)])
    finally:
        model.train(was_training)

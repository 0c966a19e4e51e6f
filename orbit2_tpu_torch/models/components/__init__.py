from orbit2_tpu_torch.models.components.blocks import (
    Attention,
    Block,
    DropPath,
    LayerScale,
    Mlp,
    VariableMappingAttention,
)

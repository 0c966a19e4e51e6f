from orbit2_tpu_torch.data.itermodule import IterDataModule
from orbit2_tpu_torch.data.loader import BatchLoader, collate, collate_continuous
from orbit2_tpu_torch.data.reader import (
    ContinuousForecast,
    DirectForecast,
    Downscale,
    IndividualDataIter,
    NpyReader,
    ShuffleIterableDataset,
    halo_lrtb,
    tile_shapes,
    tile_slices,
)
from orbit2_tpu_torch.data.transforms import LogTransform, Normalize

"""IterDataModule — the data module used by all ORBIT-2 entry points.

A copy of orbit2_tpu/data/itermodule.py (itself a rebuild of reference
src/climate_learn/data/itermodule.py:29-506): dataloaders are plain
generators of numpy batches, prefetched by a background thread
(data/loader.py). The in-RAM native sample store path is not ported.
Protocol methods (`get_lat_lon`, `get_data_dims`, `get_climatology`,
`get_normalize`, `get_out_transforms`, `setup`, `*_dataloader`) match the
reference so loaders.py can stay 1:1.
"""

from __future__ import annotations

import copy
import glob
import os
import random
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from orbit2_tpu_torch.data.reader import (
    ContinuousForecast,
    DirectForecast,
    Downscale,
    IndividualDataIter,
    InterleavedDataIter,
    NpyReader,
    ShuffleIterableDataset,
    tile_shapes,
)
from orbit2_tpu_torch.data.transforms import LogTransform, Normalize
from orbit2_tpu_torch.data.processing.era5_constants import PRECIP_VARIABLES
from orbit2_tpu_torch.data.loader import BatchLoader


class IterDataModule:
    def __init__(
        self,
        task: str,
        inp_root_dir: str,
        out_root_dir: str,
        in_vars: List[str],
        out_vars: Optional[List[str]] = None,
        data_par_size: int = 1,
        data_par_rank: int = 0,
        src: Optional[str] = None,
        history: int = 1,
        window: int = 6,
        pred_range: int = 6,
        random_lead_time: bool = True,
        max_pred_range: int = 120,
        hrs_each_step: int = 1,
        subsample: int = 1,
        buffer_size: int = 10000,
        batch_size: int = 64,
        num_workers: int = 0,
        drop_last: bool = False,
        div: int = 1,
        overlap: int = 4,
        seed: int = 0,
    ):
        self.task = task
        self.inp_root_dir = inp_root_dir
        self.out_root_dir = out_root_dir
        self.in_vars = list(in_vars)
        self.out_vars = list(out_vars) if out_vars is not None else list(in_vars)
        self.subsample = subsample
        self.buffer_size = buffer_size
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.data_par_size = data_par_size
        self.data_par_rank = data_par_rank
        self.div = div
        self.overlap = overlap
        self.history = history
        self.seed = seed

        if task in ("direct-forecasting", "iterative-forecasting"):
            self.dataset_caller = DirectForecast
            self.dataset_arg = {
                "src": src,
                "pred_range": pred_range,
                "history": history,
                "window": window,
            }
            self.continuous = False
        elif task == "continuous-forecasting":
            self.dataset_caller = ContinuousForecast
            self.dataset_arg = {
                "random_lead_time": random_lead_time,
                "min_pred_range": pred_range,
                "max_pred_range": max_pred_range,
                "hrs_each_step": hrs_each_step,
                "history": history,
                "window": window,
            }
            self.continuous = True
        elif task == "downscaling":
            self.dataset_caller = Downscale
            self.dataset_arg = {}
            self.continuous = False
        else:
            raise ValueError(f"unknown task {task}")

        def lister(root, split):
            return sorted(glob.glob(os.path.join(root, split, "*.npz")))

        self.inp_lister_train = lister(inp_root_dir, "train")
        self.out_lister_train = lister(out_root_dir, "train")
        self.inp_lister_val = lister(inp_root_dir, "val")
        self.out_lister_val = lister(out_root_dir, "val")
        self.inp_lister_test = lister(inp_root_dir, "test")
        self.out_lister_test = lister(out_root_dir, "test")

        self.transforms = self.get_normalize(inp_root_dir, self.in_vars)
        self.output_transforms = self.get_normalize(out_root_dir, self.out_vars)
        self.data_train = None
        self.data_val = None
        self.data_test = None

    # ---- protocol methods -------------------------------------------------

    def get_lat_lon(self):
        lat = np.load(os.path.join(self.out_root_dir, "lat.npy"))
        lon = np.load(os.path.join(self.out_root_dir, "lon.npy"))
        return lat, lon

    def get_data_variables(self):
        out_vars = copy.deepcopy(self.out_vars)
        if "2m_temperature_extreme_mask" in out_vars:
            out_vars.remove("2m_temperature_extreme_mask")
        return self.in_vars, out_vars

    def get_data_dims(self):
        in_lat = len(np.load(os.path.join(self.inp_root_dir, "lat.npy")))
        in_lon = len(np.load(os.path.join(self.inp_root_dir, "lon.npy")))
        out_lat = len(np.load(os.path.join(self.out_root_dir, "lat.npy")))
        out_lon = len(np.load(os.path.join(self.out_root_dir, "lon.npy")))

        out_vars = copy.deepcopy(self.out_vars)
        if "2m_temperature_extreme_mask" in out_vars:
            out_vars.remove("2m_temperature_extreme_mask")

        if self.task == "downscaling":
            (hgt, wid), (out_hgt, out_wid) = tile_shapes(
                self.div, self.overlap, in_lat, in_lon, out_lat, out_lon
            )
            in_size = (self.batch_size, len(self.in_vars), hgt, wid)
            out_size = (self.batch_size, len(out_vars), out_hgt, out_wid)
        else:
            n_in = len(self.in_vars)
            if self.task == "continuous-forecasting":
                # the continuous collate appends the lead-time hours as an
                # extra input channel (reference itermodule.py:491-503); the
                # reference's get_data_dims does NOT count it, so every
                # upstream conv model sized from these dims crashes on the
                # first continuous batch (its resnet.py:23 builds the stem
                # for history*C, the batch arrives with history*(C+1)).
                # Deliberate fix: report the channel count the loader
                # actually yields.
                n_in += 1
            in_size = (self.batch_size, self.history, n_in, out_lat, out_lon)
            out_size = (self.batch_size, len(out_vars), out_lat, out_lon)
        return in_size, out_size

    def get_normalize(self, root_dir, variables):
        """Per-variable Normalize, except precip -> LogTransform
        (reference itermodule.py:202-211)."""
        normalize_mean = dict(np.load(os.path.join(root_dir, "normalize_mean.npz")))
        normalize_std = dict(np.load(os.path.join(root_dir, "normalize_std.npz")))
        normed = OrderedDict()
        for var in variables:
            if var in PRECIP_VARIABLES:
                # NB: nc2npz ALSO bakes log(eps+tp)-log(eps) into the shards
                # at preprocessing (reference nc2npz.py:66-72) and the
                # reference's itermodule still routes the same variable
                # through LogTransform at runtime (itermodule.py:207-208) —
                # a double transform replicated here bit-for-bit for parity.
                normed[var] = LogTransform(m2mm=True, log1p=True, thres_mm_per_day=0.25)
            else:
                normed[var] = Normalize(normalize_mean[var][0], normalize_std[var][0])
        return normed

    def get_out_transforms(self):
        return {
            k: v
            for k, v in self.output_transforms.items()
            if k != "2m_temperature_extreme_mask"
        }

    def get_out_mask(self):
        """Validity mask for masked losses — the PRISM/DAYMET nodata
        handling (reference mapmodule.py:80-81; PRISM writes -9999 outside
        the conterminous US, prism processing NODATA). Prefers `mask.npy`
        written by the PRISM pipeline at the out root; otherwise derives
        valid = finite & != -9999 over every timestep of the first train
        shard. Returns [H, W] float32 (1 = valid), or None when targets
        carry no nodata. The derivation decompresses the first shard's
        out-variables (the reference sidesteps this by shipping a
        precomputed mask.npy, mapmodule.py:44-45), so the result is cached
        on the instance — Trainer wires the mask once per curriculum phase
        visit."""
        if hasattr(self, "_out_mask_cache"):
            return self._out_mask_cache
        self._out_mask_cache = self._derive_out_mask()
        return self._out_mask_cache

    def _derive_out_mask(self):
        path = os.path.join(self.out_root_dir, "mask.npy")
        if os.path.exists(path):
            return np.load(path).astype(np.float32)
        shards = [f for f in self.out_lister_train if "climatology" not in f]
        if not shards:
            return None
        mask = None
        with np.load(shards[0]) as npz:
            for var in self.out_vars:
                if var == "2m_temperature_extreme_mask" or var not in npz:
                    continue
                arr = npz[var]
                valid = (np.isfinite(arr) & (arr != -9999.0)).reshape(
                    -1, *arr.shape[-2:]).all(axis=0)
                mask = valid if mask is None else (mask & valid)
        if mask is None or mask.all():
            return None
        return mask.astype(np.float32)

    def get_climatology(self, split="val"):
        path = os.path.join(self.out_root_dir, split, "climatology.npz")
        clim_dict = np.load(path)
        return {
            var: np.squeeze(clim_dict[var].astype(np.float32), axis=0)
            for var in self.out_vars
            if var != "2m_temperature_extreme_mask"
        }

    # ---- pipeline construction --------------------------------------------

    def _pipeline(self, inp_files, out_files, shuffle: bool, seed_offset: int):
        """One host's sample pipeline.

        Shuffled (train) pipelines honor `num_workers` the way the
        reference's torch DataLoader does: K worker streams over disjoint
        (rank, worker)-sharded file subsets (reference iterdataset.py:52-88),
        interleaved sample-by-sample. Each sub-reader gets its OWN rng
        initialized from the same seed, so all workers (and all ranks) see
        the identical epoch file permutation and the K x data_par_size shard
        slices stay disjoint; every rng advances exactly once per epoch.
        Unshuffled (val/test) pipelines stay single-stream so evaluation
        sample order is deterministic and index-addressable (visualize).
        """
        workers = max(1, self.num_workers) if shuffle else 1
        children = []
        for worker_id in range(workers):
            rng = random.Random(self.seed + seed_offset)
            reader = NpyReader(
                inp_file_list=inp_files,
                out_file_list=out_files,
                variables=self.in_vars,
                out_variables=self.out_vars,
                data_par_size=self.data_par_size,
                data_par_rank=self.data_par_rank,
                num_workers=workers,
                worker_id=worker_id,
                shuffle=shuffle,
                div=self.div,
                overlap=self.overlap,
                rng=rng,
            )
            children.append(IndividualDataIter(
                self.dataset_caller(reader, **self.dataset_arg),
                transforms=self.transforms,
                output_transforms=self.output_transforms,
                subsample=self.subsample,
            ))
        return children[0] if workers == 1 else InterleavedDataIter(children)

    def setup(self, stage: Optional[str] = None):
        if stage != "test":
            train_iter = self._pipeline(
                self.inp_lister_train, self.out_lister_train, shuffle=True, seed_offset=0
            )
            # The buffer shuffle gets its OWN rng: the file-permutation rng
            # (inside NpyReader) must advance identically on every data-par
            # rank across epochs so the global file permutation stays
            # consistent (disjoint shards); sharing one rng would entangle
            # its state with per-rank sample counts. The buffer rng folds the
            # rank in so within-shard orders decorrelate across hosts.
            buffer_rng = random.Random(
                (self.seed * 1000003) ^ (7919 * (self.data_par_rank + 1)))
            self.data_train = ShuffleIterableDataset(
                train_iter, self.buffer_size, rng=buffer_rng)
            self.data_val = self._pipeline(
                self.inp_lister_val, self.out_lister_val, shuffle=False, seed_offset=1
            )
        self.data_test = self._pipeline(
            self.inp_lister_test, self.out_lister_test, shuffle=False, seed_offset=2
        )

    # ---- dataloaders -------------------------------------------------------

    def num_batches(self, split: str = "train") -> int:
        """Exact number of batches the split's dataloader will yield THIS
        epoch, computed from npz HEADERS only (no array data is read).

        Multi-process runs need this up front: train/eval steps are
        collective SPMD programs, so every process must take the same
        number of steps — the Trainer gathers these counts to clamp (train)
        or pad (eval) ranks whose file shards yield fewer samples. Counting
        peeks the upcoming epoch's file permutation without advancing the
        shuffle rng, so call it BEFORE creating the epoch's iterator."""
        data = {"train": self.data_train, "val": self.data_val,
                "test": self.data_test}[split]
        if data is None:
            raise RuntimeError("You must call setup() before num_batches")
        n = data.num_samples()
        if split == "train" and self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def train_dataloader(self):
        if self.data_train is None:
            raise RuntimeError("You must call setup() before the data loaders")
        return BatchLoader(
            self.data_train,
            batch_size=self.batch_size,
            drop_last=self.drop_last,
            continuous=self.continuous,
            prefetch=max(2, self.num_workers),
        )

    def val_dataloader(self):
        if self.data_val is None:
            raise RuntimeError("You must call setup() before the data loaders")
        return BatchLoader(
            self.data_val,
            batch_size=self.batch_size,
            drop_last=False,
            continuous=self.continuous,
            prefetch=max(2, self.num_workers),
        )

    def test_dataloader(self):
        if self.data_test is None:
            raise RuntimeError("You must call setup() before the data loaders")
        return BatchLoader(
            self.data_test,
            batch_size=self.batch_size,
            drop_last=False,
            continuous=self.continuous,
            prefetch=max(2, self.num_workers),
        )

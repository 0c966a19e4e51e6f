"""Streaming npz-shard reader with TILES spatial tiling.

A copy of orbit2_tpu/data/reader.py (the rebuild of the reference's
src/climate_learn/data/iterdataset.py:21-404): plain numpy generators.
File-level sharding is keyed by (host shard rank, worker id) exactly like the
reference keys it by (data-parallel rank, dataloader worker)
(iterdataset.py:52-88).

Tiling (the TILES algorithm): each field is cut into div x div tiles with an
asymmetric halo — the longitude halo is 2x the latitude halo because lon
resolution is 2x lat in the ERA5 grids (reference iterdataset.py:112-121);
edge tiles borrow their halo inward so every tile has identical shape
(:123-170). The same index math drives stitched inference (utils/visualize).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def halo_lrtb(overlap: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) halo widths in *input* pixels.

    Even overlap: symmetric; odd overlap: right/bottom get the extra row, and
    lon halos are always 2x lat halos (reference iterdataset.py:112-119).
    """
    if overlap % 2 == 0:
        left = right = overlap // 2 * 2
        top = bottom = overlap // 2
    else:
        left = overlap // 2 * 2
        right = (overlap // 2 + 1) * 2
        top = overlap // 2
        bottom = overlap // 2 + 1
    return left, right, top, bottom


@dataclass(frozen=True)
class TileSlice:
    vindex: int
    hindex: int
    yi: Tuple[int, int]
    xi: Tuple[int, int]
    yo: Tuple[int, int]
    xo: Tuple[int, int]


def tile_slices(
    div: int, overlap: int, yinp: int, xinp: int, yout: int, xout: int
) -> List[TileSlice]:
    """All div*div tile slices for an (yinp, xinp) -> (yout, xout) SR pair.

    Exact port of the slice arithmetic at reference iterdataset.py:123-170.
    """
    hmul = xout // xinp
    vmul = yout // yinp
    left, right, top, bottom = halo_lrtb(overlap)
    tiles = []
    for vindex in range(div):
        for hindex in range(div):
            if div == 1:
                xi1, xi2, xo1, xo2 = 0, xinp, 0, xout
                yi1, yi2, yo1, yo2 = 0, yinp, 0, yout
            else:
                xi1 = xinp // div * hindex
                xi2 = xinp // div * (hindex + 1)
                xo1 = xout // div * hindex
                xo2 = xout // div * (hindex + 1)
                if hindex == 0:
                    xi2 += left
                    xo2 += left * hmul
                else:
                    xi1 -= left
                    xo1 -= left * hmul
                if hindex == div - 1:
                    xi1 -= right
                    xo1 -= right * hmul
                else:
                    xi2 += right
                    xo2 += right * hmul

                yi1 = yinp // div * vindex
                yi2 = yinp // div * (vindex + 1)
                yo1 = yout // div * vindex
                yo2 = yout // div * (vindex + 1)
                if vindex == 0:
                    yi2 += top
                    yo2 += top * vmul
                else:
                    yi1 -= top
                    yo1 -= top * vmul
                if vindex == div - 1:
                    yi1 -= bottom
                    yo1 -= bottom * vmul
                else:
                    yi2 += bottom
                    yo2 += bottom * vmul
            tiles.append(
                TileSlice(vindex, hindex, (yi1, yi2), (xi1, xi2), (yo1, yo2), (xo1, xo2))
            )
    return tiles


def tile_shapes(
    div: int, overlap: int, in_lat: int, in_lon: int, out_lat: int, out_lon: int
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(in_hw, out_hw) tile shapes (reference itermodule.py:161-198)."""
    left, right, top, bottom = halo_lrtb(overlap)
    if div == 1:
        return (in_lat, in_lon), (out_lat, out_lon)
    hgt = in_lat // div + top + bottom
    wid = in_lon // div + left + right
    out_hgt = out_lat // div + (top + bottom) * (out_lat // in_lat)
    out_wid = out_lon // div + (left + right) * (out_lon // in_lon)
    return (hgt, wid), (out_hgt, out_wid)


Sample = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Sequence[str], Sequence[str]]


_TIME_LEN_CACHE: Dict[Tuple[str, str], int] = {}


def npz_time_len(path: str, var: str) -> int:
    """T (leading dim) of `var` inside an npz WITHOUT loading the array:
    only the member's npy header is read through the zip, so counting a
    multi-GB shard costs a few KB of IO. Shards are immutable during a run,
    so results are cached per (path, var)."""
    key = (path, var)
    if key not in _TIME_LEN_CACHE:
        import zipfile

        from numpy.lib import format as npfmt

        with zipfile.ZipFile(path) as z:
            with z.open(var + ".npy") as f:
                version = npfmt.read_magic(f)
                if version == (1, 0):
                    shape, _, _ = npfmt.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, _, _ = npfmt.read_array_header_2_0(f)
                else:  # future header versions share the private reader
                    shape, _, _ = npfmt._read_array_header(f, version)
        _TIME_LEN_CACHE[key] = int(shape[0])
    return _TIME_LEN_CACHE[key]


class NpyReader:
    """Iterates (inp_dict, out_dict, in_vars, out_vars) of [T, h, w] arrays
    per tile per shard file (reference iterdataset.py:21-177)."""

    def __init__(
        self,
        inp_file_list: Sequence[str],
        out_file_list: Sequence[str],
        variables: Sequence[str],
        out_variables: Optional[Sequence[str]] = None,
        data_par_size: int = 1,
        data_par_rank: int = 0,
        num_workers: int = 1,
        worker_id: int = 0,
        shuffle: bool = False,
        div: int = 1,
        overlap: int = 4,
        rng: Optional[random.Random] = None,
    ):
        assert len(inp_file_list) == len(out_file_list)
        self.inp_file_list = [f for f in inp_file_list if "climatology" not in f]
        self.out_file_list = [f for f in out_file_list if "climatology" not in f]
        self.variables = list(variables)
        self.out_variables = list(out_variables) if out_variables is not None else list(variables)
        self.shuffle = shuffle
        self.data_par_size = data_par_size
        self.data_par_rank = data_par_rank
        self.num_workers = max(1, num_workers)
        self.worker_id = worker_id
        self.div = div
        self.overlap = overlap
        self.rng = rng or random.Random()

    def _sharded_files(self, peek: bool = False) -> List[Tuple[str, str]]:
        """peek=True computes the shard the NEXT __iter__ will see without
        advancing the file-permutation rng (used by the batch-count peek:
        shard MEMBERSHIP depends on the epoch's permutation, so counts for
        unequal-length files are only exact for the upcoming epoch)."""
        pairs = list(zip(self.inp_file_list, self.out_file_list))
        if self.shuffle:
            rng = self.rng
            if peek:
                rng = random.Random()
                rng.setstate(self.rng.getstate())
            rng.shuffle(pairs)
        n_files = len(pairs)
        num_shards = self.num_workers * self.data_par_size
        # Wrap-around replication up to the next multiple of the shard
        # count. The reference only wraps when files < shards
        # (iterdataset.py:61-66) and otherwise floor-divides, silently
        # serving NO shard the last n_files % num_shards files of each
        # epoch's permutation (up to num_shards-1 whole shard files lost
        # per epoch). Padding from the head of the same permutation keeps
        # every shard equal-length (lockstep batch counts across ranks)
        # while serving every file at least once per epoch; for
        # files < shards this reduces bit-exactly to the reference's
        # n_multiply/n_remain arithmetic.
        if n_files % num_shards != 0:
            target = -(-n_files // num_shards) * num_shards
            pairs = (pairs * -(-target // n_files))[:target]
            n_files = len(pairs)
        per_worker = n_files // num_shards
        shard_id = self.data_par_rank * self.num_workers + self.worker_id
        return pairs[shard_id * per_worker : (shard_id + 1) * per_worker]

    def chunk_lengths(self) -> List[int]:
        """Time length of every [T, h, w] chunk the NEXT __iter__ will yield
        (div*div tiles per sharded file), from npz headers only. Does not
        advance the shuffle rng — call before creating the epoch iterator."""
        lens: List[int] = []
        for path_inp, _ in self._sharded_files(peek=True):
            t = npz_time_len(path_inp, self.variables[0])
            lens.extend([t] * (self.div * self.div))
        return lens

    def __iter__(self) -> Iterator[Sample]:
        for path_inp, path_out in self._sharded_files():
            # each variable read once a file (an NpzFile reads a member anew at
            # every index), every tile a copy of its slice of it
            inp_data = _members(path_inp, self.variables)
            out_data = _members(path_out, self.out_variables)

            k0, k1 = self.variables[0], self.out_variables[0]
            # arrays are [T, 1, H, W] (reference :103-110)
            yinp, xinp = inp_data[k0].shape[2], inp_data[k0].shape[3]
            yout, xout = out_data[k1].shape[2], out_data[k1].shape[3]

            for t in tile_slices(self.div, self.overlap, yinp, xinp, yout, xout):
                yield (
                    {
                        k: np.array(inp_data[k][:, 0, t.yi[0] : t.yi[1], t.xi[0] : t.xi[1]])
                        for k in self.variables
                    },
                    {
                        k: np.array(out_data[k][:, 0, t.yo[0] : t.yo[1], t.xo[0] : t.xo[1]])
                        for k in self.out_variables
                    },
                    self.variables,
                    self.out_variables,
                )


def _members(path: str, keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """The arrays `keys` of the npz at `path`, each read once."""
    with np.load(path) as f:
        return {k: f[k] for k in keys}


class Downscale:
    """float32 cast (reference iterdataset.py:313-328)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def chunk_lengths(self) -> List[int]:
        return self.dataset.chunk_lengths()

    def __iter__(self):
        for inp, out, variables, out_variables in self.dataset:
            yield (
                {k: np.asarray(v, dtype=np.float32) for k, v in inp.items()},
                {k: np.asarray(v, dtype=np.float32) for k, v in out.items()},
                variables,
                out_variables,
            )


class DirectForecast:
    """history/window/pred_range rolling forecast pairs
    (reference iterdataset.py:194-240)."""

    def __init__(self, dataset, src, pred_range=6, history=3, window=6):
        self.dataset = dataset
        self.history = history
        if src == "era5":
            self.pred_range = pred_range
            self.window = window
        elif src == "mpi-esm1-2-hr":
            assert pred_range % 6 == 0 and window % 6 == 0
            self.pred_range = pred_range // 6
            self.window = window // 6
        else:
            self.pred_range = pred_range
            self.window = window

    def chunk_lengths(self) -> List[int]:
        off = (self.history - 1) * self.window + self.pred_range
        # v[:, :-off] -> T-off rows; off==0 would slice v[:, :0] (empty)
        return [max(0, t - off) if off > 0 else 0
                for t in self.dataset.chunk_lengths()]

    def __iter__(self):
        for inp_data, out_data, variables, out_variables in self.dataset:
            inp = {
                k: np.stack(
                    [np.roll(v.astype(np.float32), -t * self.window, axis=0)
                     for t in range(self.history)],
                    axis=0,
                )
                for k, v in inp_data.items()
            }
            last_idx = -((self.history - 1) * self.window + self.pred_range)
            inp = {k: np.swapaxes(v[:, :last_idx], 0, 1) for k, v in inp.items()}  # N,T,H,W
            n = inp[variables[0]].shape[0]
            output_ids = np.arange(n) + (self.history - 1) * self.window + self.pred_range
            out = {k: v.astype(np.float32)[output_ids] for k, v in out_data.items()}
            yield inp, out, variables, out_variables


class ContinuousForecast:
    """Random lead-time forecasting (reference iterdataset.py:243-310)."""

    def __init__(
        self,
        dataset,
        random_lead_time=True,
        min_pred_range=6,
        max_pred_range=120,
        hrs_each_step=1,
        history=3,
        window=6,
        rng: Optional[np.random.Generator] = None,
    ):
        if not random_lead_time:
            assert min_pred_range == max_pred_range
        self.dataset = dataset
        self.random_lead_time = random_lead_time
        self.min_pred_range = min_pred_range
        self.max_pred_range = max_pred_range
        self.hrs_each_step = hrs_each_step
        self.history = history
        self.window = window
        self.rng = rng or np.random.default_rng()

    def chunk_lengths(self) -> List[int]:
        off = (self.history - 1) * self.window + self.max_pred_range
        return [max(0, t - off) if off > 0 else 0
                for t in self.dataset.chunk_lengths()]

    def __iter__(self):
        for inp_data, out_data, variables, out_variables in self.dataset:
            inp = {
                k: np.stack(
                    [np.roll(v.astype(np.float32), -t * self.window, axis=0)
                     for t in range(self.history)],
                    axis=0,
                )
                for k, v in inp_data.items()
            }
            last_idx = -((self.history - 1) * self.window + self.max_pred_range)
            inp = {k: np.swapaxes(v[:, :last_idx], 0, 1) for k, v in inp.items()}
            n = inp[variables[0]].shape[0]
            if self.random_lead_time:
                predict_ranges = self.rng.integers(
                    self.min_pred_range, self.max_pred_range + 1, size=(n,)
                )
            else:
                predict_ranges = np.full((n,), self.max_pred_range, dtype=np.int64)
            lead_times = (self.hrs_each_step * predict_ranges / 100).astype(np.float32)
            output_ids = np.arange(n) + (self.history - 1) * self.window + predict_ranges
            out = {k: v.astype(np.float32)[output_ids] for k, v in out_data.items()}
            yield inp, out, lead_times, variables, out_variables


class IndividualDataIter:
    """Per-sample slicing at `subsample` stride + normalization
    (reference iterdataset.py:331-383)."""

    def __init__(self, dataset, transforms, output_transforms, subsample=6):
        self.dataset = dataset
        self.transforms = transforms
        self.output_transforms = output_transforms
        self.subsample = subsample

    def num_samples(self) -> int:
        """Exact count the next __iter__ yields, from npz headers only:
        range(0, L, subsample) has ceil(L/subsample) elements per chunk."""
        return sum((n + self.subsample - 1) // self.subsample
                   for n in self.dataset.chunk_lengths())

    def __iter__(self):
        continuous = isinstance(self.dataset, ContinuousForecast)
        for sample in self.dataset:
            if continuous:
                inp, out, lead_times, variables, out_variables = sample
            else:
                inp, out, variables, out_variables = sample
            inp_lens = {inp[k].shape[0] for k in inp}
            out_lens = {out[k].shape[0] for k in out}
            assert len(inp_lens) == 1 and len(out_lens) == 1
            (inp_len,) = inp_lens
            assert inp_len == next(iter(out_lens))
            for i in range(0, inp_len, self.subsample):
                x = {k: inp[k][i] for k in inp}
                y = {k: out[k][i] for k in out}
                if self.transforms is not None:
                    x = {k: self.transforms[k](v) for k, v in x.items()}
                if self.output_transforms is not None:
                    y = {k: self.output_transforms[k](v) for k, v in y.items()}
                if continuous:
                    yield x, y, lead_times[i], variables, out_variables
                else:
                    yield x, y, variables, out_variables


class InterleavedDataIter:
    """Sample-level round-robin over K per-worker pipelines.

    The reference reads shards through a torch DataLoader with
    `num_workers` worker processes, each iterating a DISJOINT file subset
    keyed by (data-par rank, worker id) (reference iterdataset.py:52-88) —
    so consecutive training batches mix samples from `num_workers`
    different shard files. The rebuild's single-stream reader lost that
    interleaving, and scripts/shuffle_quality.py measured the cost on an
    adversarially non-IID (seasonally drifting) dataset: one sequential
    stream recovers only ~61% of the (no-shuffle -> exact-global-shuffle)
    validation-quality gap, while two interleaved streams are statistically
    indistinguishable from the exact global permutation
    (docs/results_shuffle_quality.json).

    This wrapper restores the reference's worker semantics without worker
    processes: K sub-pipelines (each an IndividualDataIter over a
    worker-sharded NpyReader) are drained one sample at a time, round-robin,
    under the shuffle buffer. Exhausted children drop out of the rotation.
    """

    def __init__(self, children: Sequence):
        assert len(children) >= 1
        self.children = list(children)

    def num_samples(self) -> int:
        return sum(c.num_samples() for c in self.children)

    def __iter__(self):
        active = [iter(c) for c in self.children]
        while active:
            nxt = []
            for it in active:
                try:
                    yield next(it)
                except StopIteration:
                    continue
                nxt.append(it)
            active = nxt


class ShuffleIterableDataset:
    """Streaming shuffle buffer (reference iterdataset.py:386-404)."""

    def __init__(self, dataset, buffer_size: int, rng: Optional[random.Random] = None):
        assert buffer_size > 0
        self.dataset = dataset
        self.buffer_size = buffer_size
        self.rng = rng or random.Random()

    def num_samples(self) -> int:
        return self.dataset.num_samples()  # buffer reorders, never drops

    def __iter__(self):
        buf = []
        for x in self.dataset:
            if len(buf) == self.buffer_size:
                idx = self.rng.randint(0, self.buffer_size - 1)
                yield buf[idx]
                buf[idx] = x
            else:
                buf.append(x)
        self.rng.shuffle(buf)
        while buf:
            yield buf.pop()

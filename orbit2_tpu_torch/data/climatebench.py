"""ClimateBench (CMIP6 emissions -> climate projection) data module.

A copy of orbit2_tpu/data/climatebench.py, which imports no JAX. Rebuild
of reference data/climatebench_dataset.py:11-187 +
climatebench_module.py:31-171: forcing inputs (CO2, SO2, CH4, BC) as sliding
history windows over historical+scenario simulations, mean-over-members
targets (tas/pr...), train-stat normalization shared with val/test, and the
lat-weighted |mean| normalization used by the NRMSE metrics.

The netCDF reading path (`load_x_y`) is xarray-gated like the reference; all
windowing/normalization logic is pure numpy and works with arrays from any
source (tests feed synthetic arrays via `from_arrays`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

LEN_HISTORICAL = 165


def load_x_y(data_path: str, list_simu: Sequence[str], out_var: Sequence[str]):
    """netCDF loading (reference climatebench_dataset.py:11-86): historical
    concat for ssp* scenarios, member-mean outputs, pr/pr90 scaled by 86400."""
    try:
        import xarray as xr
    except ImportError as e:  # pragma: no cover
        raise ImportError("ClimateBench nc loading needs xarray (offline env)") from e

    x_all, y_all = {}, {}
    for simu in list_simu:
        input_name = f"inputs_{simu}.nc"
        output_name = f"outputs_{simu}.nc"
        if "hist" in simu:
            input_xr = xr.open_dataset(os.path.join(data_path, input_name))
            output_xr = xr.open_dataset(os.path.join(data_path, output_name)).mean(dim="member")
        else:
            input_xr = xr.open_mfdataset(
                [os.path.join(data_path, "inputs_historical.nc"),
                 os.path.join(data_path, input_name)]).compute()
            output_xr = xr.concat(
                [xr.open_dataset(os.path.join(data_path, "outputs_historical.nc")).mean(dim="member"),
                 xr.open_dataset(os.path.join(data_path, output_name)).mean(dim="member")],
                dim="time").compute()
        output_xr = (
            output_xr.assign({"pr": output_xr.pr * 86400, "pr90": output_xr.pr90 * 86400})
            .rename({"lon": "longitude", "lat": "latitude"})
            .transpose("time", "latitude", "longitude")
            .drop(["quantile"])
        )
        x = input_xr.to_array().to_numpy().transpose(1, 0, 2, 3).astype(np.float32)
        y = output_xr[list(out_var)].to_array().to_numpy().transpose(1, 0, 2, 3).astype(np.float32)
        x_all[simu], y_all[simu] = x, y

    temp = xr.open_dataset(os.path.join(data_path, f"inputs_{list_simu[0]}.nc")).compute()
    lat_name = "latitude" if "latitude" in temp else "lat"
    lon_name = "longitude" if "longitude" in temp else "lon"
    return x_all, y_all, np.array(temp[lat_name]), np.array(temp[lon_name])


def input_for_training(x, skip_historical, history, len_historical=LEN_HISTORICAL):
    """Sliding history windows (reference :88-104)."""
    t = x.shape[0]
    start = len_historical - history + 1 if skip_historical else 0
    return np.array([x[i:i + history] for i in range(start, t - history + 1)])


def output_for_training(y, skip_historical, history, len_historical=LEN_HISTORICAL):
    """Target = last element of each window (reference :107-122)."""
    t = y.shape[0]
    start = len_historical - history + 1 if skip_historical else 0
    return np.array([y[i + history - 1] for i in range(start, t - history + 1)])


def split_train_val(x, y, train_ratio=0.9, rng: Optional[np.random.Generator] = None):
    """reference :126-131 (np.random.permutation)."""
    rng = rng or np.random.default_rng()
    ids = rng.permutation(x.shape[0])
    n = int(train_ratio * x.shape[0])
    return x[ids[:n]], y[ids[:n]], x[ids[n:]], y[ids[n:]]


class _ChannelNormalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, x):  # x: [..., C, H, W] with C matching mean
        shape = (-1,) + (1,) * 2
        return (x - self.mean.reshape(shape)) / self.std.reshape(shape)


class ClimateBenchDataset:
    """reference climatebench_dataset.py:134-187."""

    def __init__(self, x, y, variables, out_variables, lat, partition="train"):
        self.x = np.asarray(x, np.float32)  # [N, T, C, H, W]
        self.y = np.asarray(y, np.float32)  # [N, 1, H, W]
        self.variables = list(variables)
        self.out_variables = list(out_variables)
        self.lat = lat
        self.partition = partition
        if partition == "train":
            mean = self.x.mean(axis=(0, 1, 3, 4))
            std = self.x.std(axis=(0, 1, 3, 4))
            self.inp_transform = _ChannelNormalize(mean, std)
            self.out_transform = _ChannelNormalize([0.0], [1.0])
        else:
            self.inp_transform = None
            self.out_transform = None
        if partition == "test":
            # ClimateBench evaluates 2080-2100 only (reference :156-159)
            self.x = self.x[-21:]
            self.y = self.y[-21:]
            self._compute_rmse_normalization()

    def set_normalize(self, inp_t, out_t):
        self.inp_transform = inp_t
        self.out_transform = out_t

    def _compute_rmse_normalization(self):
        y_avg = self.y.squeeze(1).mean(0)
        w = np.cos(np.deg2rad(np.asarray(self.lat)))
        w = (w / w.mean())[:, None]
        self.y_normalization = float(abs((y_avg * w).mean()))

    def __len__(self):
        return self.x.shape[0]

    def __getitem__(self, i):
        x = self.inp_transform(self.x[i])
        y = self.out_transform(self.y[i])
        return x, y, self.variables, self.out_variables


class ClimateBenchDataModule:
    """reference climatebench_module.py:31-171 — same data-module protocol as
    IterDataModule so `load_climatebench_module` works unchanged.

    NB: the default simulation list + skip_historical=(i < 2) replicate the
    reference experiments (climate_projection/*.py:70-86) exactly — which
    means the 1850-2014 window enters the train/val pool twice (once via
    unskipped ssp585, once via 'historical'). Kept bit-for-bit; pass a
    custom list_train_simu to deduplicate."""

    def __init__(
        self,
        root_dir: Optional[str] = None,
        history: int = 10,
        list_train_simu=("ssp126", "ssp370", "ssp585", "historical",
                          "hist-GHG", "hist-aer"),
        list_test_simu=("ssp245",),
        variables=("CO2", "SO2", "CH4", "BC"),
        out_variables="tas",
        train_ratio: float = 0.9,
        batch_size: int = 128,
        seed: int = 0,
        _arrays=None,  # testing hook: (x_trainval dict, y dict, lat, lon)
    ):
        if isinstance(out_variables, str):
            out_variables = [out_variables]
        self.variables = list(variables)
        self.out_variables = list(out_variables)
        self.batch_size = batch_size
        self.history = history

        if _arrays is not None:
            dict_x, dict_y, lat, lon = _arrays
            dict_x_test = {list_test_simu[0]: dict_x[list(dict_x)[0]]}
            dict_y_test = {list_test_simu[0]: dict_y[list(dict_y)[0]]}
        else:
            dict_x, dict_y, lat, lon = load_x_y(
                os.path.join(root_dir, "train_val"), list(list_train_simu),
                self.out_variables)
            dict_x_test, dict_y_test, _, _ = load_x_y(
                os.path.join(root_dir, "test"), list(list_test_simu),
                self.out_variables)
        self.lat, self.lon = lat, lon

        x_tv = np.concatenate([
            input_for_training(dict_x[s], skip_historical=(i < 2),
                               history=history)
            for i, s in enumerate(dict_x.keys())
        ])
        y_tv = np.concatenate([
            output_for_training(dict_y[s], skip_historical=(i < 2),
                                history=history)
            for i, s in enumerate(dict_y.keys())
        ])
        rng = np.random.default_rng(seed)
        x_train, y_train, x_val, y_val = split_train_val(x_tv, y_tv, train_ratio, rng)

        self.dataset_train = ClimateBenchDataset(
            x_train, y_train, self.variables, self.out_variables, lat, "train")
        self.dataset_val = ClimateBenchDataset(
            x_val, y_val, self.variables, self.out_variables, lat, "val")
        self.dataset_val.set_normalize(self.dataset_train.inp_transform,
                                       self.dataset_train.out_transform)

        key = list(dict_x_test)[0]
        x_test = input_for_training(dict_x_test[key], skip_historical=True,
                                    history=history)
        y_test = output_for_training(dict_y_test[key], skip_historical=True,
                                     history=history)
        self.dataset_test = ClimateBenchDataset(
            x_test, y_test, self.variables, self.out_variables, lat, "test")
        self.dataset_test.set_normalize(self.dataset_train.inp_transform,
                                        self.dataset_train.out_transform)

    # ---- protocol -----------------------------------------------------------

    def setup(self, stage=None):
        pass

    def get_lat_lon(self):
        return self.lat, self.lon

    def get_data_variables(self):
        return self.variables, self.out_variables

    def get_data_dims(self):
        x, y, _, _ = self.dataset_train[0]
        return ((self.batch_size,) + x.shape, (self.batch_size,) + y.shape)

    def get_climatology(self, split="test"):
        return {self.out_variables[0]:
                np.asarray([self.dataset_test.y_normalization], np.float32)}

    def get_out_transforms(self):
        return {self.out_variables[0]: self.dataset_train.out_transform}

    def _loader(self, ds, shuffle, seed=0):
        idx = np.arange(len(ds))
        if shuffle:
            # fresh permutation per call: torch DataLoader(shuffle=True)
            # reshuffles every epoch; a fixed seed would freeze batch order
            self._epoch = getattr(self, "_epoch", -1) + 1
            np.random.default_rng(seed + self._epoch).shuffle(idx)
        bs = self.batch_size
        for lo in range(0, len(idx), bs):
            chunk = idx[lo:lo + bs]
            xs, ys = [], []
            for i in chunk:
                x, y, _, _ = ds[int(i)]
                xs.append(x)
                ys.append(y)
            yield (np.stack(xs), np.stack(ys), self.variables, self.out_variables)

    def train_dataloader(self):
        return self._loader(self.dataset_train, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.dataset_val, shuffle=False)

    def test_dataloader(self):
        return self._loader(self.dataset_test, shuffle=False)

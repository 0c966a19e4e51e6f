"""ERA5 variable naming/metadata tables.

Same facts as the reference's constants module (reference
data/processing/era5_constants.py — these are ERA5/WeatherBench conventions,
not code), organized as one spec table from which the lookup dicts derive.
Each entry: long name -> (short code, unit, kind) where kind is
's' = single-level, 'p' = pressure-level.
"""

_SPEC = {
    # single-level fields
    "2m_temperature": ("t2m", "K", "s"),
    "2m_temperature_min": ("t2m_min", "K", "s"),
    "2m_temperature_max": ("t2m_max", "K", "s"),
    "10m_u_component_of_wind": ("u10", "m/s", "s"),
    "10m_v_component_of_wind": ("v10", "m/s", "s"),
    "mean_sea_level_pressure": ("msl", "Pa", "s"),
    "surface_pressure": ("sp", "Pa", "s"),
    "toa_incident_solar_radiation": ("tisr", "J/m^2", "s"),
    "total_precipitation_24hr": ("tp", "m", "s"),
    "total_cloud_cover": ("tcc", None, "s"),
    "land_sea_mask": ("lsm", None, "s"),
    "orography": ("orography", None, "s"),
    "lattitude": ("lat2d", None, "s"),  # [sic] reference spelling
    # pressure-level fields
    "geopotential": ("z", "m^2/s^2", "p"),
    "u_component_of_wind": ("u", "m/s", "p"),
    "v_component_of_wind": ("v", "m/s", "p"),
    "temperature": ("t", "K", "p"),
    "relative_humidity": ("r", "%", "p"),
    "specific_humidity": ("q", "kg/kg", "p"),
    "vorticity": ("vo", "1/s", "p"),
    "potential_vorticity": ("pv", "K m^2 / (kg s)", "p"),
}

NAME_TO_VAR = {name: code for name, (code, _, _) in _SPEC.items()}
VAR_TO_NAME = {code: name for name, code in NAME_TO_VAR.items()}
VAR_TO_UNIT = {name: unit for name, (_, unit, _) in _SPEC.items()}
SINGLE_LEVEL_VARS = [n for n, (_, _, kind) in _SPEC.items() if kind == "s"]
PRESSURE_LEVEL_VARS = [n for n, (_, _, kind) in _SPEC.items() if kind == "p"]

# variables treated as log-precip in normalization (itermodule/LogTransform)
PRECIP_VARIABLES = ["total_precipitation_24hr"]

DEFAULT_PRESSURE_LEVELS = [50, 250, 500, 600, 700, 850, 925]
SR_PRESSURE_LEVELS = [500, 850]

# channels whose predictions are replaced by ground truth in
# clip_replace_constant (reference intermediate_downscaling.py:267-278)
CONSTANTS = ["orography", "land_sea_mask", "slt", "lattitude", "longitude"]

NAME_LEVEL_TO_VAR_LEVEL = {n: NAME_TO_VAR[n] for n in SINGLE_LEVEL_VARS}
for _var in PRESSURE_LEVEL_VARS:
    for _l in DEFAULT_PRESSURE_LEVELS:
        NAME_LEVEL_TO_VAR_LEVEL[f"{_var}_{_l}"] = f"{NAME_TO_VAR[_var]}_{_l}"
VAR_LEVEL_TO_NAME_LEVEL = {v: k for k, v in NAME_LEVEL_TO_VAR_LEVEL.items()}

"""Validated YAML configuration schema (a copy of orbit2_tpu/config.py).

Mirrors the reference's YAML layout (reference: configs/interm_8m.yaml:1,
parsed with raw dict indexing at examples/intermediate_downscaling.py:393-455)
but validates types/ranges up front instead of failing mid-run. Two additions
over the reference: a `parallelism.seq_par` axis that is actually implemented,
and `trainer.remat` to control per-Block rematerialization (the reference
hardcodes activation checkpointing on, intermediate_downscaling.py:634-637).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional



class ConfigError(ValueError):
    pass


@dataclass
class TrainerConfig:
    max_epochs: int = 100
    checkpoint: Optional[str] = None
    pretrain: Optional[str] = None
    batch_size: int = 32
    buffer_size: int = 400
    num_workers: int = 2
    data_type: str = "bfloat16"  # compute dtype; master params stay fp32
    train_loss: str = "bayesian_tv"
    remat: bool = True
    remat_policy: str = "full"  # full | dots (jax.checkpoint_policies)
    # Adam first-moment storage dtype. bfloat16 halves mu's HBM footprint
    # and cuts optimizer bandwidth (~5 ms/step at 1B, docs/performance.md);
    # the second moment stays fp32 (the precision-critical one). Default
    # fp32 = exact torch-AdamW parity.
    adam_mu_dtype: str = "float32"
    # Adam second-moment storage dtype. bfloat16 frees the other ~1.9GB at
    # 1B scale; arithmetic stays fp32 (optim.py::_scale_by_adam_2dtypes),
    # only inter-step storage is cast. Opt-in: nu is the precision-critical
    # moment — convergence re-verified on-chip before shipping as a default
    # (docs/performance.md, round 4).
    adam_nu_dtype: str = "float32"
    seed: int = 0
    # data-order seed: file permutations + reservoir shuffle derive from
    # THIS seed, so data order can vary across runs without touching the
    # model-init seed (the reference reshuffles per epoch via torch's
    # global RNG, which couples the two). None = follow `seed`.
    data_seed: Optional[int] = None
    # training task: downscaling (reference intermediate_downscaling.py) or
    # forecasting/continuous-forecasting (reference load_forecasting_module,
    # loaders.py:225-236; DirectForecast/ContinuousForecast iterdataset
    # wrappers). Forecast data knobs live under data: (history/window/...).
    task: str = "downscaling"
    # epochs trained per dataset phase before rotating to the next data_key
    # (reference interval_epochs=1, intermediate_downscaling.py:490)
    interval_epochs: int = 1
    # gradient accumulation: batch_size splits into grad_accum microbatches
    # per optimizer update (reference trains interm_1b/10b at bs32 over
    # 128-256 ranks; this reproduces the effective batch on small meshes)
    grad_accum: int = 1
    # persistent XLA compilation-cache directory: a second run of the same
    # config skips the cold compile (minutes at 1B+). No reference
    # analogue — torch eager pays no compile cost. Overridable with
    # ORBIT2_COMPILATION_CACHE=/path (env wins, like ORBIT2_USE_SAMPLESTORE).
    compilation_cache: Optional[str] = None

    def validate(self):
        if self.task not in ("downscaling", "forecasting",
                             "continuous-forecasting"):
            raise ConfigError(
                "task must be downscaling|forecasting|continuous-forecasting,"
                f" got {self.task}")
        if self.data_type not in ("bfloat16", "float32"):
            raise ConfigError(f"data_type must be bfloat16|float32, got {self.data_type}")
        if self.remat_policy not in ("full", "dots"):
            raise ConfigError(f"remat_policy must be full|dots, got {self.remat_policy}")
        if self.adam_mu_dtype not in ("float32", "bfloat16"):
            raise ConfigError(
                f"adam_mu_dtype must be float32|bfloat16, got {self.adam_mu_dtype}")
        if self.adam_nu_dtype not in ("float32", "bfloat16"):
            raise ConfigError(
                f"adam_nu_dtype must be float32|bfloat16, got {self.adam_nu_dtype}")
        if self.max_epochs <= 0 or self.batch_size <= 0:
            raise ConfigError("max_epochs and batch_size must be positive")
        if self.grad_accum < 1 or self.batch_size % self.grad_accum:
            raise ConfigError(
                f"grad_accum ({self.grad_accum}) must be >= 1 and divide "
                f"batch_size ({self.batch_size})")


@dataclass
class ParallelismConfig:
    """Mesh axis sizes. data-parallel size = fsdp * simple_ddp (reference
    intermediate_downscaling.py:449); total devices = fsdp * simple_ddp *
    tensor_par * seq_par."""

    # auto: true lets the Trainer pick the mesh at startup via the scaling
    # planner (utils/scaling.py::choose_mesh — least collective traffic
    # among HBM-fitting candidates for the live device count); the explicit
    # axis sizes below must then stay at their defaults. This replaces the
    # reference's hand-tuned per-config rank layouts
    # (reference configs/interm_10b.yaml:15-17).
    auto: bool = False
    fsdp: int = 1
    simple_ddp: int = 1
    tensor_par: int = 1
    seq_par: int = 1
    # seq-parallel attention kernel: "gather" (KV all-gather, supports
    # attention dropout), "ring" (ppermute k/v chunks, O(N/seq) K/V memory),
    # or "ulysses" (all-to-all tokens<->heads; needs heads % seq == 0)
    seq_impl: str = "gather"
    # pipeline parallelism over the transformer trunk (parallel/pipeline.py;
    # the reference has no PP — SURVEY §2.7). stage is the outermost mesh
    # axis; model.depth must be divisible by it.
    pipeline: int = 1
    # GPipe microbatches per step; 0 -> = pipeline. Must divide batch_size.
    pipeline_microbatches: int = 0
    # Megatron-style interleaved/circular schedule: each stage holds this
    # many round-robin chunks of depth/(pipeline*interleave) blocks, and a
    # microbatch rides the stage ring that many times — shrinks the
    # fill/drain bubble by the same factor (parallel/pipeline.py). Needs
    # microbatches >= pipeline so wraps land before re-admission.
    pipeline_interleave: int = 1
    # expert parallelism for MoE trunks (models/components/moe.py; needs
    # model.moe_experts > 0 and moe_experts % expert_par == 0)
    expert_par: int = 1

    @property
    def data_par(self) -> int:
        return self.fsdp * self.simple_ddp

    @property
    def world_size(self) -> int:
        return (self.fsdp * self.simple_ddp * self.tensor_par *
                self.seq_par * self.pipeline * self.expert_par)

    def validate(self):
        for name in ("fsdp", "simple_ddp", "tensor_par", "seq_par",
                     "pipeline", "expert_par", "pipeline_interleave"):
            if getattr(self, name) < 1:
                raise ConfigError(f"parallelism.{name} must be >= 1")
        if self.seq_impl not in ("gather", "ring", "ulysses"):
            raise ConfigError(
                "parallelism.seq_impl must be gather|ring|ulysses, "
                f"got {self.seq_impl}")
        if self.pipeline_microbatches < 0:
            raise ConfigError("parallelism.pipeline_microbatches must be >= 0")
        if self.auto and self.world_size != 1:
            raise ConfigError(
                "parallelism.auto picks the mesh itself — remove the "
                "explicit fsdp/simple_ddp/tensor_par/seq_par/pipeline/"
                "expert_par sizes (or set auto: false)")
        if self.pipeline > 1 and self.seq_par > 1:
            raise ConfigError(
                "parallelism.pipeline composes with fsdp/simple_ddp/"
                "tensor_par; seq_par inside a pipelined trunk is future "
                "work (parallel/pipeline.py scope)")


@dataclass
class TilingConfig:
    do_tiling: bool = False
    div: int = 1
    overlap: int = 0

    def validate(self):
        if self.do_tiling and self.div < 2:
            raise ConfigError("tiling.div must be >= 2 when do_tiling")
        if self.overlap < 0:
            raise ConfigError("tiling.overlap must be >= 0")

    @property
    def effective_div(self) -> int:
        return self.div if self.do_tiling else 1

    @property
    def effective_overlap(self) -> int:
        return self.overlap if self.do_tiling else 0


@dataclass
class ModelConfig:
    preset: str = "res_slimvit"
    lr: float = 2e-3
    weight_decay: float = 1e-5
    beta_1: float = 0.9
    beta_2: float = 0.99
    warmup_epochs: int = 2
    warmup_start_lr: float = 1e-7
    eta_min: float = 1e-8
    superres_mag: int = 4
    cnn_ratio: int = 4
    patch_size: int = 2
    embed_dim: int = 256
    depth: int = 6
    decoder_depth: int = 4
    num_heads: int = 4
    mlp_ratio: float = 4.0
    drop_path: float = 0.1
    drop_rate: float = 0.1
    attention_impl: str = "auto"  # auto | pallas | xla | naive
    # GELU form in the trunk MLPs: "exact" (erf — torch-reference parity
    # numerics, default) or "tanh" (approximation; measured -4.5% trunk
    # step time at 117M, scripts/bench_r4_fusion.py)
    gelu_approx: str = "exact"
    # Mixture-of-Experts trunk (models/components/moe.py; reference has no
    # MoE — this is the `ep` parallelism slot). moe_experts > 0 swaps the
    # dense MLP for a MoE one in every moe_every-th Block; the Switch
    # load-balance aux loss is weighted by moe_aux_weight in training.
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01

    def validate(self):
        if self.embed_dim % self.num_heads != 0:
            raise ConfigError("embed_dim must be divisible by num_heads")
        if self.attention_impl not in ("auto", "pallas", "xla", "naive"):
            raise ConfigError(f"unknown attention_impl {self.attention_impl}")
        if self.gelu_approx not in ("exact", "tanh"):
            raise ConfigError(f"unknown gelu_approx {self.gelu_approx}")
        if self.moe_experts < 0:
            raise ConfigError("model.moe_experts must be >= 0")
        if self.moe_experts:
            if self.moe_every < 1:
                raise ConfigError("model.moe_every must be >= 1")
            if self.moe_top_k not in (1, 2):
                raise ConfigError("model.moe_top_k must be 1 or 2")
            if self.moe_top_k > self.moe_experts:
                raise ConfigError(
                    f"model.moe_top_k ({self.moe_top_k}) must be <= "
                    f"model.moe_experts ({self.moe_experts})")
            if self.moe_capacity_factor <= 0:
                raise ConfigError("model.moe_capacity_factor must be > 0")


@dataclass
class DataConfig:
    low_res_dir: Dict[str, str] = field(default_factory=dict)
    high_res_dir: Dict[str, str] = field(default_factory=dict)
    spatial_resolution: Dict[str, float] = field(default_factory=dict)
    default_vars: List[str] = field(default_factory=list)
    dict_in_variables: Dict[str, List[str]] = field(default_factory=dict)
    dict_out_variables: Dict[str, List[str]] = field(default_factory=dict)
    var_weights: Dict[str, float] = field(default_factory=dict)
    # forecasting-task knobs (unused for downscaling): reference
    # IterDataModule defaults (itermodule.py:39-58). `src` selects the
    # DirectForecast lead-time semantics: "mpi-esm1-2-hr" data is 6-hourly,
    # so pred_range/window (given in HOURS) divide by 6
    # (reference iterdataset.py:199-207)
    src: str = "era5"
    history: int = 1
    window: int = 6
    pred_range: int = 6
    random_lead_time: bool = True
    max_pred_range: int = 120
    hrs_each_step: int = 1

    def validate(self):
        if self.src not in ("era5", "mpi-esm1-2-hr"):
            raise ConfigError(
                f"data.src must be 'era5' or 'mpi-esm1-2-hr', got {self.src!r}")
        if set(self.low_res_dir) != set(self.high_res_dir):
            raise ConfigError("low_res_dir and high_res_dir must have identical keys")
        for key in self.low_res_dir:
            if key not in self.dict_in_variables:
                raise ConfigError(f"dict_in_variables missing data key {key}")
            if key not in self.dict_out_variables:
                raise ConfigError(f"dict_out_variables missing data key {key}")
            if key not in self.spatial_resolution:
                # extra spatial_resolution keys are fine (the reference ships
                # all five dataset keys with only two active) but every
                # ACTIVE phase needs one — a typo'd key would otherwise fail
                # deep inside model.for_phase
                raise ConfigError(f"spatial_resolution missing data key {key}")
            for v in self.dict_in_variables[key]:
                if v not in self.default_vars:
                    raise ConfigError(f"in variable {v} not in default_vars")


@dataclass
class Config:
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    parallelism: ParallelismConfig = field(default_factory=ParallelismConfig)
    tiling: TilingConfig = field(default_factory=TilingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def validate(self) -> "Config":
        self.trainer.validate()
        self.parallelism.validate()
        self.tiling.validate()
        self.model.validate()
        self.data.validate()
        if self.model.num_heads % self.parallelism.tensor_par != 0:
            # reference asserts the same (intermediate_downscaling.py:168)
            raise ConfigError("num_heads must be divisible by tensor_par")
        if (self.parallelism.pipeline_interleave > 1
                and self.parallelism.pipeline == 1):
            raise ConfigError(
                "parallelism.pipeline_interleave > 1 needs pipeline > 1")
        if self.parallelism.pipeline > 1:
            sv = (self.parallelism.pipeline
                  * self.parallelism.pipeline_interleave)
            if self.model.depth % sv != 0:
                raise ConfigError(
                    f"model.depth ({self.model.depth}) must be divisible by "
                    f"parallelism.pipeline x pipeline_interleave ({sv})")
            mb = (self.parallelism.pipeline_microbatches
                  or self.parallelism.pipeline)
            if self.trainer.batch_size % mb != 0:
                raise ConfigError(
                    f"trainer.batch_size ({self.trainer.batch_size}) must be "
                    f"divisible by pipeline microbatches ({mb})")
            if (self.parallelism.pipeline_interleave > 1
                    and mb < self.parallelism.pipeline):
                raise ConfigError(
                    f"pipeline_interleave > 1 needs microbatches ({mb}) >= "
                    f"pipeline ({self.parallelism.pipeline}) so wrapped "
                    f"activations arrive before re-admission")
            if self.model.preset != "res_slimvit":
                raise ConfigError(
                    "parallelism.pipeline > 1 is only supported for the "
                    "res_slimvit trunk")
            if self.model.moe_experts:
                raise ConfigError(
                    "model.moe_experts inside a pipelined trunk is future "
                    "work (the stacked-block pipeline shares one Block "
                    "template; MoE blocks alternate with dense ones)")
        if self.model.moe_experts and self.model.preset != "res_slimvit":
            raise ConfigError(
                "model.moe_experts is only supported for the res_slimvit "
                "trunk (models/components/moe.py)")
        if self.model.moe_experts and self.model.moe_every > self.model.depth:
            raise ConfigError(
                f"model.moe_every ({self.model.moe_every}) > model.depth "
                f"({self.model.depth}) produces zero MoE layers; lower "
                f"moe_every or set moe_experts: 0")
        if self.model.moe_experts and self.parallelism.seq_par > 1:
            raise ConfigError(
                "model.moe_experts with parallelism.seq_par > 1 is future "
                "work: MoE dispatch/combine pin the token dim replicated "
                "(models/components/moe.py), so a sharded seq axis would "
                "force a full token all-gather per MoE block")
        if self.parallelism.expert_par > 1:
            if not self.model.moe_experts:
                raise ConfigError(
                    "parallelism.expert_par > 1 needs model.moe_experts > 0")
            if self.model.moe_experts % self.parallelism.expert_par != 0:
                raise ConfigError(
                    f"model.moe_experts ({self.model.moe_experts}) must be "
                    f"divisible by parallelism.expert_par "
                    f"({self.parallelism.expert_par})")
        return self


def _build(cls, raw: Optional[Dict[str, Any]]):
    raw = dict(raw or {})
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - names
    if unknown:
        raise ConfigError(f"unknown keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {
        f.name: raw[f.name]
        for f in dataclasses.fields(cls)
        if f.name in raw and raw[f.name] is not None
    }
    cfg = cls(**kwargs)
    # coerce numeric strings (reference float()s them manually, :429-436)
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        if isinstance(getattr(cls(), f.name, None), float) and isinstance(v, (str, int)):
            setattr(cfg, f.name, float(v))
        elif isinstance(getattr(cls(), f.name, None), int) and isinstance(v, str):
            setattr(cfg, f.name, int(v))
    return cfg


def load_config(path_or_dict) -> Config:
    """Load and validate a config from a YAML path or a raw dict."""
    if isinstance(path_or_dict, (str, os.PathLike)):
        import yaml  # only YAML paths need PyYAML

        with open(path_or_dict) as f:
            raw = yaml.safe_load(f)
    else:
        raw = dict(path_or_dict)
    cfg = Config(
        trainer=_build(TrainerConfig, raw.get("trainer")),
        parallelism=_build(ParallelismConfig, raw.get("parallelism")),
        tiling=_build(TilingConfig, raw.get("tiling")),
        model=_build(ModelConfig, raw.get("model")),
        data=_build(DataConfig, raw.get("data")),
    )
    return cfg.validate()

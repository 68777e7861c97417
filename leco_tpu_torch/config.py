"""Config tree: a dict (or YAML) -> typed dataclasses.

Counterpart of `leco_tpu/config.py`, with the same sections, field names
and defaults. The JAX package validates with pydantic; the machine the port
targets has no pydantic, so the tree is plain dataclasses built by
`RootConfig.from_dict`, which keeps pydantic's behaviour where the repo
relies on it: unknown keys are ignored (docs/QUIRKS.md #5), numbers given as
strings are coerced (YAML reads `1e-4` as a string), Literal fields are
checked, and missing or null sections are default-constructed.
`parse_precision` returns torch dtypes. YAML files are read by
`utils/yaml_subset.py`, since the target machine has no PyYAML either.
"""

import dataclasses
import typing
from typing import Literal, Optional, Union

import torch

from leco_tpu_torch.utils import yaml_subset

PRECISION_TYPES = Literal["fp32", "fp16", "bf16", "float32", "float16", "bfloat16"]
NETWORK_TYPES = Literal["lierla", "c3lier"]
TRAINING_METHODS = Literal["noxattn", "innoxattn", "selfattn", "xattn", "full"]
SCHEDULER_TYPES = Literal["ddim", "ddpm", "lms", "euler_a"]


def _coerce(tp, value, where: str):
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None:
            return None
        return _coerce(args[0], value, where)
    if origin is Literal:
        if value not in typing.get_args(tp):
            raise ValueError(f"{where}: {value!r} is not one of {typing.get_args(tp)}")
        return value
    if dataclasses.is_dataclass(tp):
        return value if isinstance(value, tp) else tp.from_dict(value or {})
    if tp is bool:
        if not isinstance(value, bool):
            raise ValueError(f"{where}: {value!r} is not a bool")
        return value
    if tp in (int, float):
        if isinstance(value, bool):
            raise ValueError(f"{where}: {value!r} is not a number")
        coerced = tp(value)
        if tp is int and isinstance(value, float) and value != coerced:
            raise ValueError(f"{where}: {value!r} is not an integer")
        return coerced
    if tp is str:
        if not isinstance(value, str):
            raise ValueError(f"{where}: {value!r} is not a string")
        return value
    return value


class _Section:
    """`from_dict`: keep the known keys (coerced), ignore the rest."""

    @classmethod
    def from_dict(cls, values: dict):
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in values:
                kwargs[f.name] = _coerce(
                    hints[f.name], values[f.name], f"{cls.__name__}.{f.name}"
                )
        missing = [
            f.name for f in dataclasses.fields(cls)
            if f.name not in kwargs
            and f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        ]
        if missing:
            raise ValueError(f"{cls.__name__}: missing fields {missing}")
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PretrainedModelConfig(_Section):
    name_or_path: str
    v2: bool = False
    v_pred: bool = False
    clip_skip: Optional[int] = None


@dataclasses.dataclass
class NetworkConfig(_Section):
    type: NETWORK_TYPES = "lierla"
    rank: int = 4
    alpha: float = 1.0
    training_method: TRAINING_METHODS = "full"


@dataclasses.dataclass
class TrainConfig(_Section):
    precision: PRECISION_TYPES = "bfloat16"
    noise_scheduler: SCHEDULER_TYPES = "ddim"
    iterations: int = 500
    lr: float = 1e-4
    optimizer: str = "adamw"
    optimizer_args: str = ""
    lr_scheduler: str = "constant"
    max_denoising_steps: int = 50
    # extensions of the JAX package; see leco_tpu/config.py for each
    seed: Optional[int] = None
    data_parallel: bool = True
    checkpoint_unet: bool = False
    save_state: bool = False
    resume: bool = False
    ema_decay: float = 0.0
    step_chunk: int = 1
    tensor_parallel: int = 1
    spatial_parallel: int = 1


@dataclasses.dataclass
class SaveConfig(_Section):
    name: str = "untitled"
    path: str = "./output"
    per_steps: int = 200
    precision: PRECISION_TYPES = "float32"
    async_write: bool = True


@dataclasses.dataclass
class LoggingConfig(_Section):
    use_wandb: bool = False
    verbose: bool = False
    interval: int = 1


@dataclasses.dataclass
class OtherConfig(_Section):
    use_xformers: bool = False
    use_flash_attention: Optional[bool] = None


@dataclasses.dataclass
class RootConfig(_Section):
    prompts_file: str
    pretrained_model: PretrainedModelConfig
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    train: Optional[TrainConfig] = None
    save: Optional[SaveConfig] = None
    logging: Optional[LoggingConfig] = None
    other: Optional[OtherConfig] = None

    def __post_init__(self):
        self.train = self.train or TrainConfig()
        self.save = self.save or SaveConfig()
        self.logging = self.logging or LoggingConfig()
        self.other = self.other or OtherConfig()


def parse_precision(precision: str) -> torch.dtype:
    """Precision string -> torch dtype (reference: config_util.py:75-83)."""
    if precision in ("fp32", "float32"):
        return torch.float32
    if precision in ("fp16", "float16"):
        return torch.float16
    if precision in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"Invalid precision type: {precision}")


def load_config_from_yaml(config_path: str) -> RootConfig:
    """Load YAML and default-fill missing sections (config_util.py:86-104).
    The file is read by the port's own reader (`utils/yaml_subset.py`)."""
    return RootConfig.from_dict(yaml_subset.load(config_path))

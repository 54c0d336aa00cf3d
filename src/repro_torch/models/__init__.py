"""Model zoo (port of `repro/models/`): the ten architectures' forward,
training and serving paths.

`config` and `spec` describe a model; `layers`, `transformer`, `ssm` and
`hybrid` apply it functionally over a nested dict of tensors, in the
reference's layouts; `model.Model` owns the parameters as an `nn.Module`
whose names mirror the reference's tree; `convert.params_from_jax` moves
the reference's values across.
"""

from repro_torch.models.config import EncoderConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.models.model import Model, active_params, total_params
from repro_torch.models.spec import (
    TensorSpec,
    abstract_tree,
    count_params,
    init_tree,
    partition_tree,
    tree_bytes,
)

__all__ = [
    "EncoderConfig",
    "Model",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "TensorSpec",
    "abstract_tree",
    "active_params",
    "count_params",
    "init_tree",
    "partition_tree",
    "total_params",
    "tree_bytes",
]

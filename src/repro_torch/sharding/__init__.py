"""Logical sharding on ``torch.distributed`` device meshes (port of
``repro.sharding``): the rules, the context and the specs."""

from repro_torch.sharding.ctx import (PartitionSpec, activation_rules,
                                      current_mesh, logical_constraint,
                                      param_sharding_rules, to_placements)
from repro_torch.sharding.specs import (LOGICAL_RULES, input_specs_sharding,
                                        param_specs)

__all__ = [
    "activation_rules", "logical_constraint", "current_mesh",
    "param_sharding_rules", "param_specs", "input_specs_sharding",
    "LOGICAL_RULES", "PartitionSpec", "to_placements",
]

"""LM scaffolding (port of ``repro/models``): the ten architectures'
decoder-only and encoder-decoder models, their blocks and layers."""
from repro_torch.models.api import (
    input_sharding, input_specs, make_inputs, model_apply, model_init,
    model_state_init, model_state_specs, pick_mode,
)
from repro_torch.models.blocks import Mode

__all__ = ["input_sharding", "input_specs", "make_inputs", "model_apply",
           "model_init", "model_state_init", "model_state_specs",
           "pick_mode", "Mode"]

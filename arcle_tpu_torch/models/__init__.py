from .mlp import (
    FCPolicy, obs_width, stack_padded_logits, gumbel_uniforms,
    multi_categorical_sample, multi_categorical_log_prob,
    multi_categorical_entropy, WLinear, HyperMLP,
)
from .gpt import GPTConfig, GPTPolicy, active_mask
from .dt import DTConfig, DTPolicy
from .truncated_normal import TruncatedNormal
from . import bbox_dist
from .convert import (
    fcpolicy_state_dict_from_flax, gpt_state_dict_from_flax,
    dt_state_dict_from_flax, hypermlp_state_dict_from_flax,
    adam_state_from_optax,
)

__all__ = [
    "FCPolicy", "obs_width", "stack_padded_logits", "gumbel_uniforms",
    "multi_categorical_sample", "multi_categorical_log_prob",
    "multi_categorical_entropy", "WLinear", "HyperMLP", "GPTConfig", "GPTPolicy", "active_mask",
    "DTConfig", "DTPolicy",
    "TruncatedNormal", "bbox_dist", "fcpolicy_state_dict_from_flax",
    "gpt_state_dict_from_flax", "dt_state_dict_from_flax",
    "hypermlp_state_dict_from_flax",
    "adam_state_from_optax",
]

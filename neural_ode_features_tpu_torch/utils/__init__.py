from .checkpoint import from_jax_params, from_torch_state_dict, to_torch_state_dict

__all__ = ["from_jax_params", "from_torch_state_dict", "to_torch_state_dict"]

from .from_jax import (
    load_clip_from_jax,
    load_from_jax,
    load_gpt_from_jax,
    load_lpips_from_jax,
    load_patch_discriminator_from_jax,
    load_rq_from_jax,
    load_style_discriminator_from_jax,
    load_vitvq_from_jax,
    to_jax_tree,
)
from .torch_loader import (
    load_gpt_params,
    load_style_discriminator_params,
    load_torch_state_dict,
    load_vitvq_params,
)

__all__ = ["load_from_jax", "load_vitvq_from_jax", "load_gpt_from_jax",
           "load_rq_from_jax", "load_style_discriminator_from_jax",
           "load_lpips_from_jax", "load_patch_discriminator_from_jax",
           "load_clip_from_jax", "to_jax_tree", "load_torch_state_dict",
           "load_vitvq_params", "load_gpt_params",
           "load_style_discriminator_params"]

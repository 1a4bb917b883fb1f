from .from_jax import (
    load_from_jax,
    load_gpt_from_jax,
    load_lpips_from_jax,
    load_patch_discriminator_from_jax,
    load_rq_from_jax,
    load_style_discriminator_from_jax,
    load_vitvq_from_jax,
)

__all__ = ["load_from_jax", "load_vitvq_from_jax", "load_gpt_from_jax",
           "load_rq_from_jax", "load_style_discriminator_from_jax",
           "load_lpips_from_jax", "load_patch_discriminator_from_jax"]

from .from_jax import load_vitvq_from_jax

__all__ = ["load_vitvq_from_jax"]

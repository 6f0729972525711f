"""Device-side state containers (camera rig, pyramids, patch batches)."""

import dataclasses

import jax


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (every field a leaf),
    with ``obj.replace(**fields)`` for functional updates."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    cls.replace = replace
    return jax.tree_util.register_dataclass(cls)

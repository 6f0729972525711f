"""pais_mvs_tpu — a dense multi-view-stereo reconstruction engine in JAX.

A from-scratch JAX/XLA re-design of the patch-based MVS pipeline of
PAIS/TMVS (reference: adahbingee/pais-mvs): NVM camera ingest, seed patch
triangulation, batched GLN-PSO patch optimization scored by adaptively
weighted photoconsistency, cell-grid expansion, outlier filtering, and
PLY/PSR export.

Architecture differences from the reference (by design, not accident):
  * All per-patch work is batched: thousands of PSO swarms advance in
    lockstep as ``[B, P]`` tensor programs under ``jit``/``vmap`` instead of
    one sequential swarm at a time (reference: TMVS/mvs/mvs.cpp:196-275).
  * Patch state is a fixed-capacity struct-of-arrays arena with validity
    masks, not a ``map<int, Patch>``.
  * Expansion is wavefront rounds over the cell grid, not a serial priority
    queue (set-level semantics preserved; insertion order is a heuristic in
    the reference itself — it ships four orderings).
  * Multi-device scaling shards the patch batch over a ``jax.sharding.Mesh``
    with XLA collectives; the reference has OpenMP only.
"""

import jax as _jax

# True-f32 einsums/matmuls by default: on the GPU, float32 dot_general
# otherwise runs in TF32 (about three decimal digits), which the geometry
# chain cannot afford — facing tests, plane homographies, projections and
# the NCC tables all go through f32 einsums, and a reduced-precision pass
# degrades seed accuracy on real imagery several-fold. Respect a user's own
# setting if one is already in place.
try:
    if _jax.config.jax_default_matmul_precision is None:
        _jax.config.update("jax_default_matmul_precision", "highest")
except AttributeError:          # future jax renames: fail open
    pass

from pais_mvs_tpu.config import MvsConfig, load_config_txt

__version__ = "0.1.0"

__all__ = ["MvsConfig", "load_config_txt", "__version__"]

"""Multi-process initialization (SURVEY §5.8 build equivalent).

The reference is a single process; scaling across processes here uses
``jax.distributed.initialize`` — every process runs the same program, JAX
assembles the global device mesh, and the SPMD building blocks
(`parallel.sharded`, `parallel.expansion.expand_step`,
`ops.bundle.bundle_adjust_sharded`) shard over all global devices (see
tests/mp_worker.py and bench_scaling.py's multi-process mode). The CLI's
reconstruction is one process driving every local device.

A JAX process reserves most of the memory of every GPU it opens, so
processes that share a host must each open their own card:

* with a loopback coordinator (``localhost:PORT``, ``127.x.x.x``, ``::1``)
  every process is on this host, and process ``i`` opens local GPU ``i``;
* with any other coordinator the processes may span hosts, and each opens
  every GPU its environment shows it: a launcher that starts several
  processes on one host gives each its card with ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

_LOOPBACK = ("localhost", "::1")


def _is_loopback(coordinator: str) -> bool:
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    return host in _LOOPBACK or host.startswith("127.")


def local_device_ids(coordinator: str, process_id: int) -> list[int] | None:
    """The local GPU ids this process opens (None: every visible GPU)."""
    return [process_id] if _is_loopback(coordinator) else None


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> bool:
    """Initialize multi-process JAX; returns True if more than one process
    joined.

    Must run before any other JAX call (backend initialization latches).
    """
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids(coordinator, process_id))
    return jax.process_count() > 1

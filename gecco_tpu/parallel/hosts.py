"""Multi-host orchestration: process init and contig sharding.

The reference is strictly single-process (SURVEY §2.3 — verified:
thread pools only, no MPI/NCCL/Gloo); its docs recommend splitting
inputs by hand and merging tables (``docs/training.rst:84-88``).  This
build makes that a first-class mode:

* :func:`initialize` — `jax.distributed` bootstrap for multi-host
  slices (no-op for a single process);
* :func:`contig_shard` — deterministic, length-balanced assignment of
  contigs to processes, identical on every host (no communication);
* the CLI accepts ``--shard K/N`` on ``run``/``annotate`` so each host
  processes only its contigs; per-shard tables merge with the
  multi-``-f`` concat of ``train``/``predict`` and cluster IDs are
  shard-invariant by construction (``parallel.merge_clusters``).
"""

from typing import List, Optional, Sequence, Tuple

__all__ = ["initialize", "contig_shard", "parse_shard"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize `jax.distributed` and return ``(process_id, count)``.

    With no arguments and no cluster environment this is a no-op
    returning ``(0, 1)``.
    """
    import jax

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def contig_shard(
    lengths: Sequence[int], process_id: int, process_count: int
) -> List[int]:
    """Deterministic length-balanced contig assignment (LPT greedy).

    Every process computes the same global assignment from the same
    contig length list and keeps its own slice — no communication.
    Returns the indices owned by ``process_id`` in input order.
    """
    if not 0 <= process_id < process_count:
        raise ValueError(f"process_id {process_id} not in [0, {process_count})")
    order = sorted(range(len(lengths)), key=lambda i: (-int(lengths[i]), i))
    loads = [0] * process_count
    owner = {}
    for i in order:
        s = min(range(process_count), key=lambda k: (loads[k], k))
        owner[i] = s
        loads[s] += int(lengths[i])
    return [i for i in range(len(lengths)) if owner[i] == process_id]


def parse_shard(spec: Optional[str]) -> Tuple[int, int]:
    """Parse a ``K/N`` CLI shard spec (1-based K) into ``(index, count)``."""
    if spec is None:
        return 0, 1
    try:
        k_str, n_str = spec.split("/", 1)
        k, n = int(k_str), int(n_str)
    except ValueError:
        raise ValueError(f"invalid shard spec {spec!r}; expected K/N") from None
    if not 1 <= k <= n:
        raise ValueError(f"shard index {k} not in [1, {n}]")
    return k - 1, n

"""Multi-chip scale-out: mesh construction, sharded search, merged results.

The reference is single-node thread-parallel only (``SURVEY.md`` §2.3);
this package adds the accelerator equivalents:

* **data parallelism** — contig/protein batches sharded over the
  ``data`` mesh axis (the workhorse; each chip runs the full stack on
  its shard);
* **model parallelism** — the profile bank's profile axis sharded over
  the ``model`` axis (useful when the bank outgrows HBM or to cut
  latency of single-genome annotation);
* **deterministic merge** — per-shard cluster candidates renumbered in
  coordinate order so output IDs are shard-invariant
  (reference numbering: ``refine.py:199-200``).

Training steps shard windows over ``data``; XLA inserts the gradient
all-reduce automatically because parameters are replicated.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy

__all__ = [
    "make_mesh",
    "shard_sequences",
    "sharded_forward_scores",
    "merge_clusters",
    "crf_train_step",
    "pipelined_map",
]


def _host_worker_init(initializer, initargs) -> None:
    """Hold a host worker process to the CPU, then run ``initializer``."""
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    if initializer is not None:
        initializer(*initargs)


def pipelined_map(host_fn, device_fn, items, processes: bool = False,
                  initializer=None, initargs=()):
    """Two-stage host/device software pipeline over a work list.

    Yields ``device_fn(host_fn(item))`` per item, with the NEXT item's
    ``host_fn`` running in a worker while the device processes the
    current one.  This is how a batch ``run`` keeps the chip busy:
    gene calling of genome *k+1* overlaps the annotation search of
    genome *k*, so steady-state throughput is set by
    ``max(host, device)`` instead of their sum.  The reference's analog
    is its per-contig ``ThreadPool`` inside ONE stage
    (``/root/reference/gecco/orf.py:95``); this pipelines ACROSS
    stages, which only pays off with an accelerator to keep fed.

    ``processes=True`` runs ``host_fn`` in a spawned worker PROCESS
    instead of a thread: the device path's own host-side work (batch
    packing, result assembly) holds the GIL for most of a search, so a
    thread-based overlap degrades to the serial sum — a subprocess
    overlaps fully.  ``host_fn``/``items`` must then be picklable;
    ``initializer(*initargs)`` runs once in the worker (build finders,
    banks, …).  The worker is held to the CPU (``JAX_PLATFORMS=cpu`` is
    set before anything in it can import JAX), so it never opens a
    second client on the card.
    """
    items = list(items)
    if not items:
        return
    if processes:
        import multiprocessing

        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        pool = ProcessPoolExecutor(
            max_workers=1, mp_context=ctx,
            initializer=_host_worker_init, initargs=(initializer, initargs),
        )
    else:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        if initializer is not None:
            initializer(*initargs)
    with pool:
        future = pool.submit(host_fn, items[0])
        for k in range(len(items)):
            prepared = future.result()
            if k + 1 < len(items):
                future = pool.submit(host_fn, items[k + 1])
            yield device_fn(prepared)


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1):
    """Build a ``(data, model)`` mesh over the available devices."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if model_axis > 1 and n % model_axis == 0:
        shape = (n // model_axis, model_axis)
    else:
        shape = (n, 1)
    mesh_devices = numpy.array(devices).reshape(shape)
    return Mesh(mesh_devices, ("data", "model"))


def shard_sequences(
    sequences: Sequence["numpy.ndarray"], n_shards: int
) -> List[List[int]]:
    """Round-robin-by-size assignment of sequences to shards (balanced)."""
    order = sorted(range(len(sequences)), key=lambda i: -len(sequences[i]))
    loads = [0] * n_shards
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for i in order:
        s = loads.index(min(loads))
        shards[s].append(i)
        loads[s] += len(sequences[i])
    return shards


def sharded_forward_scores(bank, xs, masks, loops, moves, mesh,
                           viterbi: bool = False):
    """Forward (or Viterbi, the F2 stage) scores with the bank sharded
    over ``model`` and sequences over ``data``; returns the full
    ``[S, P]`` score matrix.

    The computation is embarrassingly parallel over both axes — XLA
    only needs collectives to reassemble the output, which it inserts
    from the output sharding.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..hmm.batch import _jit_forward, _bank_tuple

    S, Lp = xs.shape
    fn = _jit_forward(bank.P, bank.Mp, Lp, viterbi=viterbi)

    bank_args = _bank_tuple(bank)
    spec_bank = (
        P(None, "model", None),  # e_odds [21, P, Mp]
    ) + (P("model", None),) * 8 + (P("model"),)
    bank_sharded = tuple(
        jax.device_put(jnp.asarray(a), NamedSharding(mesh, s))
        for a, s in zip(bank_args, spec_bank)
    )
    xs_s = jax.device_put(jnp.asarray(xs), NamedSharding(mesh, P("data", None)))
    masks_s = jax.device_put(jnp.asarray(masks), NamedSharding(mesh, P("data", None)))
    loops_s = jax.device_put(jnp.asarray(loops), NamedSharding(mesh, P("data")))
    moves_s = jax.device_put(jnp.asarray(moves), NamedSharding(mesh, P("data")))
    with mesh:
        out = fn(bank_sharded, xs_s, masks_s, loops_s, moves_s)
    return numpy.asarray(out)


def merge_clusters(cluster_lists: Sequence[Sequence]) -> List:
    """Merge per-shard cluster candidates deterministically.

    Clusters are reordered by (sequence id, start, end) and renumbered
    ``{seq}_cluster_{i}`` per sequence in coordinate order, so the result
    does not depend on how contigs were sharded.
    """
    from ..model import Cluster

    merged = [c for clusters in cluster_lists for c in clusters]
    merged.sort(key=lambda c: (c.source.id, c.start, c.end))
    counters: Dict[str, int] = {}
    renumbered = []
    for cluster in merged:
        seq_id = cluster.source.id
        counters[seq_id] = counters.get(seq_id, 0) + 1
        renumbered.append(Cluster(
            f"{seq_id}_cluster_{counters[seq_id]}",
            cluster.genes, cluster.type, cluster.type_probabilities,
        ))
    return renumbered


def crf_train_step(mesh):
    """Build a jitted data-parallel CRF training step over ``mesh``.

    Parameters are replicated; the window batch (feature indices +
    labels) is sharded over ``data``.  Returns ``(step_fn, init_params)``
    where ``step_fn(params, idx, y, lr) -> (params, loss)``.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    def make(A: int):
        def nll(params, idx, y):
            state, trans = params
            e = state[idx].sum(axis=2)
            path = jnp.take_along_axis(e, y[..., None], axis=2)[..., 0].sum(axis=1)
            path = path + trans[y[:, :-1], y[:, 1:]].sum(axis=1)

            def step(alpha, e_t):
                alpha = jax.scipy.special.logsumexp(
                    alpha[:, :, None] + trans[None, :, :], axis=1
                ) + e_t
                return alpha, None

            alpha, _ = jax.lax.scan(step, e[:, 0, :], jnp.moveaxis(e[:, 1:, :], 1, 0))
            logZ = jax.scipy.special.logsumexp(alpha, axis=1)
            return (logZ - path).sum()

        grad_fn = jax.value_and_grad(nll)

        def step_fn(params, idx, y, lr):
            loss, grads = grad_fn(params, idx, y)
            params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
            return params, loss

        replicated = NamedSharding(mesh, P())
        data_sharded = NamedSharding(mesh, P("data", None, None))
        labels_sharded = NamedSharding(mesh, P("data", None))
        jitted = jax.jit(
            step_fn,
            in_shardings=((replicated, replicated), data_sharded, labels_sharded, None),
            out_shardings=((replicated, replicated), replicated),
        )
        init = (jnp.zeros((A + 1, 2), jnp.float32), jnp.zeros((2, 2), jnp.float32))
        return jitted, init

    return make

"""SSV filter kernel for NVIDIA GPUs (Pallas through Triton).

The SSV filter scores every (sequence, profile) pair, so it is the one
all-pairs stage of the search.  The XLA engine (``batch._jit_ssv``)
scans over residues and carries a ``[S, P, Mp]`` plane through device
memory on every step, with every profile padded to the widest.  This
kernel keeps the DP state in registers and walks each profile only to
its true length.

Design:

* **Diagonal indexing.**  ``M_j(i) = e_j(x_i) + max(M_{j-1}(i-1),
  B_{i-1} + tbm)`` depends on its predecessor along the diagonal
  ``d = j - i`` only.  A block holds ``BD`` consecutive diagonals (lanes)
  for ``BS`` sequences (rows) and loops over the residue index ``i``;
  lane ``d`` reads the emission at node ``i + d``, a contiguous load per
  row.  No lane shift is needed.
* **Log space.**  Max-plus needs no rescaling, so scores stay in nats.
* **No carry between blocks.**  ``C`` is linear in log space:
  ``C_L = max_i (E_i + log ½ + (L - 1 - i)·loop)`` (0-based ``i``).  Each
  block keeps the running maximum of ``M + (L - 1 - i)·loop`` over its
  own cells, and one segment max over a profile's blocks finishes it.
* **A work table, not a dense grid.**  Profile ``p`` needs
  ``ceil((Lp + M_p - 1) / BD)`` diagonal blocks; the grid's first axis
  walks the flattened ``(profile, block)`` list, so no block is launched
  for the padding between a profile's length and the bank's widest.

Returns the same ``[S, P]`` nats as ``batch.ssv_scores_xla``.
"""

import functools
import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .batch import ProfileBank, _padded_batch
from .profile import length_model

__all__ = ["ssv_scores_pallas"]

BS = 16   # sequences per block (rows)
BD = 32   # diagonals per block (lanes)
NUM_WARPS = 4
LOG_HALF = math.log(0.5)


def _ssv_kernel(wp_ref, wb_ref, x_ref, len_ref, loop_ref, mlen_ref, tbm_ref,
                e_ref, out_ref, *, P: int, Mp: int, Lp: int):
    w = pl.program_id(0)
    t = pl.program_id(1)
    p = wp_ref[w]
    d0 = wb_ref[w] * BD - (Lp - 1)
    M = mlen_ref[p]
    tbm = tbm_ref[p]
    rows = pl.ds(t * BS, BS)
    L = len_ref[rows]                        # [BS]
    loop = loop_ref[rows]                    # [BS] log N/C self-loop
    lanes = d0 + jnp.arange(BD, dtype=jnp.int32)
    i_lo = jnp.maximum(0, -(d0 + BD - 1))
    i_hi = jnp.minimum(jnp.max(L), M - d0)
    neg = jnp.float32(-jnp.inf)

    def body(i, carry):
        Mv, best = carry
        xi = x_ref[i, rows]                  # [BS] residues at step i
        j = i + lanes                        # [BD] node index (0-based)
        valid = ((j >= 0) & (j < M))[None, :] & (i < L)[:, None]
        idx = (xi[:, None] * P + p) * Mp + jnp.clip(j, 0, Mp - 1)[None, :]
        e = plgpu.load(e_ref.at[idx], mask=valid, other=neg)
        fi = i.astype(jnp.float32)
        entry = (fi * loop + tbm)[:, None]   # B_{i-1} + tbm, less ``move``
        Mv = jnp.where(valid, e + jnp.maximum(Mv, entry), neg)
        tail = ((L - 1 - i).astype(jnp.float32) * loop)[:, None]
        return Mv, jnp.maximum(best, Mv + tail)

    init = jnp.full((BS, BD), neg, jnp.float32)
    _, best = jax.lax.fori_loop(i_lo, i_hi, body, (init, init))
    out_ref[w, rows] = jnp.max(best, axis=1)


@functools.lru_cache(maxsize=None)
def _compiled(P: int, Mp: int, Lp: int, S: int, W: int, interpret: bool):
    call = pl.pallas_call(
        functools.partial(_ssv_kernel, P=P, Mp=Mp, Lp=Lp),
        out_shape=jax.ShapeDtypeStruct((W, S), jnp.float32),
        grid=(W, S // BS),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="ssv_filter",
    )

    def run(loge, mlen, tbm, wp, wb, xT, lens, loops, moves):
        part = call(wp, wb, xT, lens, loops, mlen, tbm, loge)     # [W, S]
        best = jax.ops.segment_max(
            part, wp, num_segments=P, indices_are_sorted=True)    # [P, S]
        # the entry term carried no ``move``; add it with E->C and C->T
        return best.T + (2.0 * moves + LOG_HALF)[:, None]

    return jax.jit(run)


def _work_table(lengths: "numpy.ndarray", Lp: int):
    """``(profile, diagonal block)`` pairs that hold any DP cell."""
    blocks = -(-(Lp + lengths.astype(numpy.int64) - 1) // BD)
    wp = numpy.repeat(numpy.arange(len(lengths), dtype=numpy.int32), blocks)
    starts = numpy.cumsum(blocks) - blocks
    wb = (numpy.arange(len(wp)) - numpy.repeat(starts, blocks)).astype(numpy.int32)
    return wp, wb


def _device_tables(bank: ProfileBank):
    """Log-odds emissions, lengths and SSV entry scores on the current
    default device, built once per bank and device."""
    device = jax.config.jax_default_device or jax.devices()[0]
    key = ("ssv", device)
    if key not in bank.device_tables:
        M = bank.lengths.astype(numpy.float64)
        tbm = numpy.log(2.0 / (M * (M + 1.0))).astype(numpy.float32)
        with jax.default_device(device):
            loge = jnp.log(jnp.asarray(bank.e_odds)).reshape(-1)
            bank.device_tables[key] = (
                loge, jnp.asarray(bank.lengths), jnp.asarray(tbm))
    return bank.device_tables[key]


def ssv_scores_pallas(
    bank: ProfileBank,
    sequences: Sequence["numpy.ndarray"],
    pad_to: Optional[int] = None,
    interpret: bool = False,
) -> "numpy.ndarray":
    """SSV filter log-odds scores (nats) of every pair, ``[S, P]``.

    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests); otherwise it is compiled for the GPU through Triton.  A
    zero-length sequence scores ``-inf``, as ``engine.ssv_score`` does.
    """
    S = len(sequences)
    if S == 0:
        return numpy.zeros((0, bank.P), dtype=numpy.float32)
    xs, _masks, _loops, _moves = _padded_batch(sequences, pad_to)
    Lp = xs.shape[1]
    S_pad = max(BS, 1 << (S - 1).bit_length())
    xT = numpy.zeros((Lp, S_pad), dtype=numpy.int32)
    xT[:, :S] = xs.T
    lens = numpy.zeros(S_pad, dtype=numpy.int32)
    loops = numpy.zeros(S_pad, dtype=numpy.float32)
    moves = numpy.zeros(S_pad, dtype=numpy.float32)
    for s, x in enumerate(sequences):
        lens[s] = len(x)
        if len(x):   # an empty row keeps loop 0: it has no cells, and
            loop, move = length_model(len(x))   # 0·(-inf) would be NaN
            loops[s], moves[s] = loop, move
    wp, wb = _work_table(bank.lengths, Lp)
    loge, mlen, tbm = _device_tables(bank)
    fn = _compiled(bank.P, bank.Mp, Lp, S_pad, len(wp), bool(interpret))
    out = fn(loge, mlen, tbm, jnp.asarray(wp), jnp.asarray(wb),
             jnp.asarray(xT), jnp.asarray(lens), jnp.asarray(loops),
             jnp.asarray(moves))
    return numpy.asarray(out)[:S]

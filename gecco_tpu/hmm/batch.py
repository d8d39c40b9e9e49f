"""Batched profile-HMM engines for the accelerator (JAX/XLA).

The whole profile bank is packed as ``[P, Mp]`` tensors (profiles ×
padded nodes) and the dynamic program scans over *sequence positions*,
so the per-step emission lookup is a slice ``e_odds[x_i]`` of a
``[21, P, Mp]`` tensor.  The delete chain (a first-order linear
recurrence along the node axis) runs as an exact ``associative_scan``;
probability-space values are rescaled per step (HMMER's sparse-rescaling
trick) so everything stays in f32 range.

Each call is split into sequence chunks whose DP plane stays under
``PLANE_BYTES``; sequences are independent, so the split changes no
score.  On a GPU the SSV filter runs the Pallas kernel of
``gecco_tpu.hmm.ssv`` instead (``ssv_scores``).

This replaces the SIMD MSV/Viterbi/Forward filter stack of HMMER3 that
the reference uses through pyhmmer (``SURVEY.md`` §2.2); the numeric
contract is tested against ``gecco_tpu.hmm.engine``.
"""

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy

from .io import AMINO_ALPHABET
from .profile import SearchProfile, length_model

__all__ = [
    "ProfileBank", "bias_logratio", "forward_scores", "viterbi_scores",
    "msv_scores", "ssv_scores", "ssv_scores_xla",
]

_K = 21  # 20 amino acids + degenerate
PLANE_BYTES = 1 << 30  # per-dispatch bound on one [S, P, Mp] f32 DP plane


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ProfileBank:
    """A set of profiles packed into padded prob-space tensors.

    * ``e_odds`` — ``[21, P, Mp]`` match emission odds (exp of log-odds);
      0 at padded nodes, 1 for the degenerate residue row at real nodes.
    * transition tensors ``[P, Mp]`` (probability space, 0 at pads):
      ``tmm/tim/tdm`` feed node ``k+1`` from ``k``; ``tmi/tii`` stay at
      ``k``; ``tmd/tdd`` feed the delete chain; ``bm`` is local entry.
    * ``lengths`` — real model length per profile.
    * ``device_tables`` — per-device copies that device engines build
      once from this bank (``gecco_tpu.hmm.ssv``).
    """

    e_odds: "numpy.ndarray"
    tmm: "numpy.ndarray"
    tim: "numpy.ndarray"
    tdm: "numpy.ndarray"
    tmi: "numpy.ndarray"
    tii: "numpy.ndarray"
    tmd: "numpy.ndarray"
    tdd: "numpy.ndarray"
    bm: "numpy.ndarray"
    msv_tbm: "numpy.ndarray"  # [P] uniform MSV entry prob 2/(M(M+1))
    lengths: "numpy.ndarray"  # [P] int32
    names: List[str]
    accessions: List[str]
    fwd_tau: "numpy.ndarray"     # [P] FORWARD exponential-tail tau (bits)
    fwd_lambda: "numpy.ndarray"  # [P]
    msv_mu: "numpy.ndarray"      # [P] MSV Gumbel mu (bits)
    msv_lambda: "numpy.ndarray"  # [P]
    vit_mu: "numpy.ndarray"      # [P] VITERBI Gumbel mu (bits)
    vit_lambda: "numpy.ndarray"  # [P]
    device_tables: Dict = field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def P(self) -> int:
        return self.e_odds.shape[1]

    @property
    def Mp(self) -> int:
        return self.e_odds.shape[2]

    @classmethod
    def build(cls, profiles: Sequence[SearchProfile], lane: int = 128) -> "ProfileBank":
        P = len(profiles)
        Mp = _round_up(max(gm.M for gm in profiles), lane)
        e_odds = numpy.zeros((_K, P, Mp), dtype=numpy.float32)
        arrays = {
            name: numpy.zeros((P, Mp), dtype=numpy.float32)
            for name in ("tmm", "tim", "tdm", "tmi", "tii", "tmd", "tdd", "bm")
        }
        msv_tbm = numpy.zeros(P, dtype=numpy.float32)
        lengths = numpy.zeros(P, dtype=numpy.int32)
        uncalibrated: List[str] = []
        stats = {key: numpy.zeros(P, dtype=numpy.float32) for key in
                 ("fwd_tau", "fwd_lambda", "msv_mu", "msv_lambda",
                  "vit_mu", "vit_lambda")}
        names, accessions = [], []
        for p, gm in enumerate(profiles):
            M = gm.M
            # node k of the profile sits at lane k-1
            e_odds[:, p, :M] = numpy.exp(
                numpy.where(numpy.isfinite(gm.msc[1:, :]), gm.msc[1:, :], -745.0)
            ).T.astype(numpy.float32)
            for name, source in (
                ("tmm", gm.tmm), ("tim", gm.tim), ("tdm", gm.tdm),
                ("tmi", gm.tmi), ("tii", gm.tii),
                ("tmd", gm.tmd), ("tdd", gm.tdd), ("bm", gm.bm),
            ):
                values = numpy.exp(numpy.where(numpy.isfinite(source[1:]), source[1:], -745.0))
                arrays[name][p, :M] = values.astype(numpy.float32)
            msv_tbm[p] = 2.0 / (M * (M + 1.0))
            lengths[p] = M
            names.append(gm.name)
            accessions.append(gm.accession or gm.name)
            tau, lam = gm.hmm.stats.get("FORWARD", (0.0, math.log(2.0)))
            stats["fwd_tau"][p], stats["fwd_lambda"][p] = tau, lam
            # profiles without STATS MSV/VITERBI calibration must not be
            # dropped by the F1/F2 Gumbel gates (hmmsearch only applies
            # filter thresholds to calibrated models): mu = -inf makes
            # the survival p-value 0, i.e. the gate always passes
            mu, mlam = gm.hmm.stats.get("MSV", (-1e30, math.log(2.0)))
            stats["msv_mu"][p], stats["msv_lambda"][p] = mu, mlam
            vmu, vlam = gm.hmm.stats.get("VITERBI", (-1e30, math.log(2.0)))
            stats["vit_mu"][p], stats["vit_lambda"][p] = vmu, vlam
            if "MSV" not in gm.hmm.stats or "VITERBI" not in gm.hmm.stats:
                uncalibrated.append(gm.name)
        if uncalibrated:
            import warnings

            warnings.warn(
                f"{len(uncalibrated)} profile(s) lack STATS MSV/VITERBI "
                f"calibration (e.g. {uncalibrated[0]!r}); the F1/F2 filter "
                "gates will pass them through unfiltered — calibrate with "
                "gecco_tpu.hmm.calibrate for filter-speed parity",
                stacklevel=2,
            )
        return cls(
            e_odds=e_odds, msv_tbm=msv_tbm, lengths=lengths,
            names=names, accessions=accessions,
            fwd_tau=stats["fwd_tau"], fwd_lambda=stats["fwd_lambda"],
            msv_mu=stats["msv_mu"], msv_lambda=stats["msv_lambda"],
            vit_mu=stats["vit_mu"], vit_lambda=stats["vit_lambda"],
            **arrays,
        )

    def select(
        self, indices: Sequence[int], lane: int = 128, width: Optional[int] = None
    ) -> "ProfileBank":
        """Compact a sub-bank of the given profile rows (host-side gather).

        ``width`` pins the padded node width (e.g. to guarantee at least
        one trailing pad lane so kernels can skip lane-0 masking).
        """
        idx = numpy.asarray(list(indices), dtype=numpy.int64)
        if width is not None:
            Mp = width
        else:
            Mp = _round_up(max(8, int(self.lengths[idx].max())), lane) if len(idx) else lane

        def cols(a: "numpy.ndarray") -> "numpy.ndarray":
            taken = a[..., idx, : min(Mp, a.shape[-1])]
            if taken.shape[-1] < Mp:  # widen with zero pad columns
                pad = [(0, 0)] * (taken.ndim - 1) + [(0, Mp - taken.shape[-1])]
                taken = numpy.pad(taken, pad)
            return numpy.ascontiguousarray(taken)

        return ProfileBank(
            e_odds=cols(self.e_odds),
            tmm=cols(self.tmm), tim=cols(self.tim), tdm=cols(self.tdm),
            tmi=cols(self.tmi), tii=cols(self.tii),
            tmd=cols(self.tmd), tdd=cols(self.tdd), bm=cols(self.bm),
            msv_tbm=self.msv_tbm[idx], lengths=self.lengths[idx],
            names=[self.names[i] for i in idx],
            accessions=[self.accessions[i] for i in idx],
            fwd_tau=self.fwd_tau[idx], fwd_lambda=self.fwd_lambda[idx],
            msv_mu=self.msv_mu[idx], msv_lambda=self.msv_lambda[idx],
            vit_mu=self.vit_mu[idx], vit_lambda=self.vit_lambda[idx],
        )


def bias_logratio(bank: ProfileBank) -> "numpy.ndarray":
    """``log(compo_p[a] / bg[a])`` per profile — the composition filter.

    ``compo_p`` is the profile's mean match emission distribution (the
    analog of HMMER's ``COMPO`` line); derived from the bank's odds
    tensor: ``mean_k e_odds[a, p, k] = compo_p[a] / bg[a]``.
    Returns ``[20, P]`` float32.
    """
    sums = bank.e_odds[:20].sum(axis=2)            # [20, P]
    ratio = sums / numpy.maximum(bank.lengths, 1)[None, :]
    return numpy.log(numpy.maximum(ratio, 1e-30)).astype(numpy.float32)


def _bank_tuple(bank: ProfileBank):
    return (
        bank.e_odds, bank.tmm, bank.tim, bank.tdm, bank.tmi, bank.tii,
        bank.tmd, bank.tdd, bank.bm, bank.msv_tbm,
    )


@functools.lru_cache(maxsize=None)
def _jit_forward(P: int, Mp: int, Lp: int, viterbi: bool = False):
    import jax
    import jax.numpy as jnp

    # max-plus (Viterbi) vs sum-product (Forward) semiring — the uniform
    # per-step rescaling is valid for both (positive scaling commutes
    # with max as well as with +)
    add = jnp.maximum if viterbi else (lambda a, b: a + b)

    def one_sequence(args, x, mask, loop, move):
        (e_odds, tmm, tim, tdm, tmi, tii, tmd, tdd, bm, _msv) = args
        # shift-by-one helper along the node axis (node k feeds k+1)
        def shift(a):
            return jnp.pad(a[:, :-1], ((0, 0), (1, 0)))

        def dchain(m_new, tmd_s, tdd_s):
            # D_k = tdd[k-1] (*) D_{k-1} (+) m_new[k-1] * tmd[k-1]
            # (exact associative scan in either semiring)
            a = shift(tdd_s)
            b = shift(m_new * tmd_s)

            def combine(left, right):
                a1, b1 = left
                a2, b2 = right
                return a1 * a2, add(b1 * a2, b2)

            _, d = jax.lax.associative_scan(combine, (a, b), axis=1)
            return d

        def step(carry, inputs):
            M, I, D, N, B, J, C, logscale = carry
            xi, valid = inputs
            e = jax.lax.dynamic_index_in_dim(e_odds, xi, axis=0, keepdims=False)  # [P, Mp]
            stay = shift(add(add(M * tmm, I * tim), D * tdm))
            Mn = e * add(stay, B[:, None] * bm)
            In = add(M * tmi, I * tii)
            Dn = dchain(Mn, tmd, tdd)
            if viterbi:
                E = jnp.max(jnp.maximum(Mn, Dn), axis=1)
            else:
                E = jnp.sum(Mn + Dn, axis=1)
            Jn = add(J * loop, E * 0.5)
            Cn = add(C * loop, E * 0.5)
            Nn = N * loop
            Bn = add(Nn, Jn) * move
            # rescale to keep f32 in range
            total = E + Bn + Nn + Cn + 1e-30
            inv = 1.0 / total
            Mn = Mn * inv[:, None]
            In = In * inv[:, None]
            Dn = Dn * inv[:, None]
            new_logscale = logscale + jnp.log(total)
            carry_new = (Mn, In, Dn, Nn * inv, Bn * inv, Jn * inv, Cn * inv, new_logscale)
            # freeze the carry on padded positions
            merged = jax.tree_util.tree_map(
                lambda new, old: jnp.where(valid, new, old),
                carry_new, carry,
            )
            return merged, None

        M0 = jnp.zeros((P, Mp), jnp.float32)
        I0 = jnp.zeros((P, Mp), jnp.float32)
        D0 = jnp.zeros((P, Mp), jnp.float32)
        N0 = jnp.ones(P, jnp.float32)
        B0 = jnp.full(P, jnp.float32(0.0)) + move
        J0 = jnp.zeros(P, jnp.float32)
        C0 = jnp.zeros(P, jnp.float32)
        logs0 = jnp.zeros(P, jnp.float32)
        carry, _ = jax.lax.scan(
            step, (M0, I0, D0, N0, B0, J0, C0, logs0), (x, mask)
        )
        C_final, logscale = carry[6], carry[7]
        return jnp.log(C_final * move + 1e-38) + logscale

    batched = jax.vmap(one_sequence, in_axes=(None, 0, 0, 0, 0))

    def run(args, xs, masks, loops, moves):
        return batched(args, xs, masks, loops, moves)

    return jax.jit(run)


def _padded_batch(sequences, pad_to):
    """Shared host-side padding: xs, masks, loops, moves arrays."""
    S = len(sequences)
    Lp = pad_to or _round_up(max(len(x) for x in sequences), 32)
    xs = numpy.zeros((S, Lp), dtype=numpy.int32)
    masks = numpy.zeros((S, Lp), dtype=bool)
    loops = numpy.zeros(S, dtype=numpy.float32)
    moves = numpy.zeros(S, dtype=numpy.float32)
    for i, x in enumerate(sequences):
        L = len(x)
        xs[i, :L] = x
        masks[i, :L] = True
        loop, move = length_model(L)
        loops[i] = math.exp(loop)
        moves[i] = math.exp(move)
    return xs, masks, loops, moves


def _score(jitted, bank: ProfileBank, sequences, pad_to) -> "numpy.ndarray":
    """Run one XLA engine over ``sequences``, ``[S, P]`` nats.

    The batch goes out in chunks whose ``[chunk, P, Mp]`` DP plane fits
    ``PLANE_BYTES``: a genome-sized bucket against a Pfam-sized bank
    would otherwise carry several 6.5 GB planes (plus the scan's
    temporaries) in one dispatch.
    """
    import jax.numpy as jnp

    if len(sequences) == 0:
        return numpy.zeros((0, bank.P), dtype=numpy.float32)
    xs, masks, loops, moves = _padded_batch(sequences, pad_to)
    fn = jitted(bank.P, bank.Mp, xs.shape[1])
    args = tuple(jnp.asarray(a) for a in _bank_tuple(bank))
    chunk = max(1, PLANE_BYTES // (4 * bank.P * bank.Mp))
    return numpy.concatenate([
        numpy.asarray(fn(args, jnp.asarray(xs[s:s + chunk]),
                         jnp.asarray(masks[s:s + chunk]),
                         jnp.asarray(loops[s:s + chunk]),
                         jnp.asarray(moves[s:s + chunk])))
        for s in range(0, len(xs), chunk)
    ])


def forward_scores(
    bank: ProfileBank,
    sequences: Sequence["numpy.ndarray"],
    pad_to: Optional[int] = None,
) -> "numpy.ndarray":
    """Forward log-odds scores (nats) of every (sequence, profile) pair.

    Returns ``[S, P]``; each score is comparable to
    ``engine.forward(...).score`` for the same pair (f32 tolerance).
    """
    return _score(_jit_forward, bank, sequences, pad_to)


def viterbi_scores(
    bank: ProfileBank,
    sequences: Sequence["numpy.ndarray"],
    pad_to: Optional[int] = None,
) -> "numpy.ndarray":
    """Viterbi (max) log-odds scores (nats) of every pair, ``[S, P]``.

    The F2 ``ViterbiFilter`` stage of hmmsearch; the same engine as
    ``forward_scores`` in the max-plus semiring.  Per-pair values match
    ``engine.viterbi_score`` at f32 tolerance.
    """
    return _score(functools.partial(_jit_forward, viterbi=True),
                  bank, sequences, pad_to)


@functools.lru_cache(maxsize=None)
def _jit_msv(P: int, Mp: int, Lp: int):
    import jax
    import jax.numpy as jnp

    def one_sequence(args, x, mask, loop, move):
        (e_odds, *_rest, msv_tbm) = args

        def shift(a):
            return jnp.pad(a[:, :-1], ((0, 0), (1, 0)))

        def step(carry, inputs):
            M, N, B, J, C, logscale = carry
            xi, valid = inputs
            e = jax.lax.dynamic_index_in_dim(e_odds, xi, axis=0, keepdims=False)
            Mn = e * jnp.maximum(shift(M), B[:, None] * msv_tbm[:, None])
            E = jnp.max(Mn, axis=1)
            Jn = jnp.maximum(J * loop, E * 0.5)
            Cn = jnp.maximum(C * loop, E * 0.5)
            Nn = N * loop
            Bn = jnp.maximum(Nn, Jn) * move
            total = E + Bn + Nn + Cn + 1e-30
            inv = 1.0 / total
            new = (Mn * inv[:, None], Nn * inv, Bn * inv, Jn * inv, Cn * inv,
                   logscale + jnp.log(total))
            merged = tuple(jnp.where(valid, n, o) for n, o in zip(new, carry))
            return merged, None

        M0 = jnp.zeros((P, Mp), jnp.float32)
        N0 = jnp.ones(P, jnp.float32)
        B0 = jnp.zeros(P, jnp.float32) + move
        carry, _ = jax.lax.scan(
            step,
            (M0, N0, B0, jnp.zeros(P, jnp.float32), jnp.zeros(P, jnp.float32), jnp.zeros(P, jnp.float32)),
            (x, mask),
        )
        return jnp.log(carry[4] * move + 1e-38) + carry[5]

    batched = jax.vmap(one_sequence, in_axes=(None, 0, 0, 0, 0))
    return jax.jit(lambda args, xs, masks, loops, moves: batched(args, xs, masks, loops, moves))


@functools.lru_cache(maxsize=None)
def _jit_ssv(P: int, Mp: int, Lp: int):
    import jax
    import jax.numpy as jnp

    def one_sequence(args, x, mask, loop, move):
        (e_odds, *_rest, msv_tbm) = args

        def shift(a):
            return jnp.pad(a[:, :-1], ((0, 0), (1, 0)))

        def step(carry, inputs):
            M, N, B, C, logscale = carry
            xi, valid = inputs
            e = jax.lax.dynamic_index_in_dim(e_odds, xi, axis=0, keepdims=False)
            Mn = e * jnp.maximum(shift(M), B[:, None] * msv_tbm[:, None])
            E = jnp.max(Mn, axis=1)
            Cn = jnp.maximum(C * loop, E * 0.5)
            Nn = N * loop
            Bn = Nn * move
            total = E + Bn + Nn + Cn + 1e-30
            inv = 1.0 / total
            new = (Mn * inv[:, None], Nn * inv, Bn * inv, Cn * inv,
                   logscale + jnp.log(total))
            merged = tuple(jnp.where(valid, n, o) for n, o in zip(new, carry))
            return merged, None

        M0 = jnp.zeros((P, Mp), jnp.float32)
        N0 = jnp.ones(P, jnp.float32)
        B0 = jnp.zeros(P, jnp.float32) + move
        carry, _ = jax.lax.scan(
            step,
            (M0, N0, B0, jnp.zeros(P, jnp.float32), jnp.zeros(P, jnp.float32)),
            (x, mask),
        )
        return jnp.log(carry[3] * move + 1e-38) + carry[4]

    batched = jax.vmap(one_sequence, in_axes=(None, 0, 0, 0, 0))
    return jax.jit(lambda args, xs, masks, loops, moves: batched(args, xs, masks, loops, moves))


def ssv_scores_xla(
    bank: ProfileBank,
    sequences: Sequence["numpy.ndarray"],
    pad_to: Optional[int] = None,
) -> "numpy.ndarray":
    """SSV filter log-odds scores (nats) on the XLA engine, ``[S, P]``.

    Single-segment variant of ``msv_scores`` (no J state) — the stage-1
    filter of HMMER ≥3.1; matches ``engine.ssv_score`` per pair.
    """
    return _score(_jit_ssv, bank, sequences, pad_to)


def ssv_scores(
    bank: ProfileBank,
    sequences: Sequence["numpy.ndarray"],
    pad_to: Optional[int] = None,
) -> "numpy.ndarray":
    """SSV filter log-odds scores (nats) for every pair, ``[S, P]``.

    The one place the filter engine is chosen: the Pallas kernel of
    ``gecco_tpu.hmm.ssv`` on a GPU, the XLA engine elsewhere.
    """
    import jax

    if jax.default_backend() == "gpu":
        from .ssv import ssv_scores_pallas

        return ssv_scores_pallas(bank, sequences, pad_to)
    return ssv_scores_xla(bank, sequences, pad_to)


def msv_scores(
    bank: ProfileBank,
    sequences: Sequence["numpy.ndarray"],
    pad_to: Optional[int] = None,
) -> "numpy.ndarray":
    """MSV filter log-odds scores (nats) for every pair, ``[S, P]``.

    NB: probability-space max-recurrences with rescaling compute the
    same value as the log-space max DP because rescaling is monotonic
    and uniform across states within a step.
    """
    return _score(_jit_msv, bank, sequences, pad_to)

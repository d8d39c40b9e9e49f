"""hmmbuild-style E-value calibration of profile HMMs by simulation.

HMMER profiles carry ``STATS LOCAL MSV/VITERBI/FORWARD`` lines fitted
by scoring each model against a few hundred random background
sequences at build time (``hmmbuild``; the reference's Pfam ``.h3m``
files ship pre-calibrated — ``/root/reference/setup.py:344-372`` keeps
those lines intact).  Any profile built *by us* — the synthetic
benchmark banks, or user models from a future ``hmmbuild`` equivalent —
needs the same treatment, or the pipeline's filter thresholds
(``F1``/``F3`` P-values) and reported E-values are meaningless.

Method (after HMMER's ``p7_Calibrate``):

* ``lambda`` is fixed at ``log 2`` (the conjecture-backed slope for
  bit scores);
* MSV/SSV scores of random sequences follow a Gumbel; with lambda
  known, the location MLE is
  ``mu = -1/λ · log( mean( exp(-λ·bits) ) )``;
* Forward scores have an exponential right tail; ``tau`` anchors the
  survival function ``P(S ≥ x) = exp(-λ (x - tau))`` to the empirical
  ``tailp`` (default 4%) quantile.

Scoring runs on the engines of ``gecco_tpu.hmm.batch`` (the SSV
filter on the GPU kernel where there is one).
"""

import math
from typing import List, Sequence

import numpy

from .batch import ProfileBank, forward_scores, ssv_scores, viterbi_scores
from .profile import SearchProfile, null1_score

__all__ = ["calibrate"]

LOG2 = math.log(2.0)


def calibrate(
    profiles: Sequence[SearchProfile],
    n: int = 256,
    L: int = 256,
    seed: int = 0,
    tailp: float = 0.04,
) -> List[SearchProfile]:
    """Fit MSV/VITERBI/FORWARD stats in place; returns ``profiles``.

    ``n`` random background sequences of length ``L`` are scored
    against every profile; each profile's ``hmm.stats`` dict is
    replaced with the fitted ``(location, log 2)`` pairs.  Rebuild any
    :class:`~gecco_tpu.hmm.batch.ProfileBank` afterwards — banks copy
    the stats at build time.
    """
    from .io import BACKGROUND_F

    profiles = list(profiles)
    if not profiles:
        return profiles
    rng = numpy.random.default_rng(seed)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    seqs = [
        rng.choice(20, size=L, p=p_bg).astype(numpy.int32) for _ in range(n)
    ]
    bank = ProfileBank.build(profiles)
    ssv = ssv_scores(bank, seqs)
    vit = viterbi_scores(bank, seqs)
    fwd = forward_scores(bank, seqs)
    null = null1_score(L)
    bits_ssv = (ssv.astype(numpy.float64) - null) / LOG2   # [n, P]
    bits_vit = (vit.astype(numpy.float64) - null) / LOG2
    bits_fwd = (fwd.astype(numpy.float64) - null) / LOG2
    lam = LOG2
    # Gumbel location MLE with fixed lambda (MSV and Viterbi fitted
    # separately, like hmmbuild's two simulations)
    mu = -numpy.log(numpy.mean(numpy.exp(-lam * bits_ssv), axis=0)) / lam
    vmu = -numpy.log(numpy.mean(numpy.exp(-lam * bits_vit), axis=0)) / lam
    # exponential tail anchored at the empirical tail quantile
    t_tail = numpy.quantile(bits_fwd, 1.0 - tailp, axis=0)
    tau = t_tail + math.log(tailp) / lam
    for p, gm in enumerate(profiles):
        gm.hmm.stats["MSV"] = (float(mu[p]), lam)
        gm.hmm.stats["VITERBI"] = (float(vmu[p]), lam)
        gm.hmm.stats["FORWARD"] = (float(tau[p]), lam)
    return profiles

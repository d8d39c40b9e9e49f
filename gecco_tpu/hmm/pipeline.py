"""The profile-HMM search pipeline: filters, scoring, domain reporting.

Mirrors the acceleration pipeline the reference gets from
``pyhmmer.hmmer.hmmsearch`` (``/root/reference/gecco/hmmer/__init__.py:131-140``),
re-architected for the accelerator:

1. **SSV filter** — batched on-device scores of *all* (sequence,
   profile) pairs, Gumbel P-value threshold ``F1`` (default 0.02).
   Like HMMER ≥3.1 (and therefore pyhmmer) the stage-1 score is the
   single-segment SSV, thresholded with the MSV Gumbel calibration;
   ``filter_stage="msv"`` restores the multi-segment MSV filter.
1.5. **Viterbi F2 gate** — pair-dense max-plus rescore of the filter
   survivors, Gumbel P-value threshold ``F2`` (default 1e-3) — the
   ``ViterbiFilter`` stage of hmmsearch, which shapes the reported hit
   set, not just speed.  Per-stage survivor counts are recorded in
   ``stage_counts``.
2. **Forward** — batched on-device scores of surviving pairs,
   exponential-tail threshold ``F3`` (default 1e-5).  F2 and F3 rescore
   each 64-sequence chunk against the union of its survivors.
3. **domain definition** — host float64 posterior decoding, envelopes,
   null2 bias, optimal-accuracy alignment (``gecco_tpu.hmm.engine``) for
   the rare survivors.

Reporting follows hmmsearch defaults: sequence E ≤ 10 and domain
i-Evalue ≤ 10 with caller-fixed ``Z``/``domZ`` (GECCO pins both to the
HMM library size, 2766), or the profile's GA/NC/TC bit cutoffs.

Device stages run on the XLA batch engines (``gecco_tpu.hmm.batch``);
on a GPU the SSV filter runs the Pallas kernel of ``gecco_tpu.hmm.ssv``
(``batch.ssv_scores`` chooses).  ``use_accelerator=False`` is the
float64 checking path: like ``hmmsearch --max`` it skips the F1/F2 gates
and Forward-scores every pair on the host engine (reported hits are then
gated by F3/E-value only).
"""

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy

from . import engine
from .batch import (
    ProfileBank, bias_logratio, forward_scores, msv_scores, ssv_scores,
    viterbi_scores,
)
from .engine import DomainHit, exp_surv
from .profile import SearchProfile, null1_score

__all__ = ["SequenceHit", "SearchPipeline"]

LOG2 = math.log(2.0)


def _gumbel_surv_vec(y):
    """Vectorized Gumbel survival P(S > y) (``esl_gumbel_surv``).

    Two-sided clamp: the ``y > 30`` arm avoids cancellation for tiny
    tails, the lower clamp at −30 avoids overflow RuntimeWarnings for
    junk scores (the result is exactly 1.0 there either way).
    """
    return numpy.where(
        y > 30, numpy.exp(-numpy.minimum(y, 700.0)),
        1.0 - numpy.exp(-numpy.exp(-numpy.clip(y, -30, 30))),
    )


def _pow2_cap(L, floor: int = 5) -> int:
    """Power-of-two length cap for XLA compile-shape bucketing."""
    return 1 << max(floor, int(math.ceil(math.log2(max(1, int(L))))))


def _exp_surv_vec(bits, tau, lam):
    """Vectorized ``engine.exp_surv``: exponential right-tail survival."""
    return numpy.where(
        bits <= tau, 1.0,
        numpy.exp(-lam * numpy.maximum(bits - tau, 0.0)))


@dataclass
class SequenceHit:
    """All reported domains of one (sequence, profile) comparison."""

    sequence_index: int
    profile: SearchProfile
    score: float              # full-sequence bit score
    pvalue: float
    evalue: float
    domains: List[DomainHit] = field(default_factory=list)


class SearchPipeline:
    """hmmsearch-equivalent many-vs-many search."""

    def __init__(
        self,
        profiles: Sequence[SearchProfile],
        Z: Optional[float] = None,
        domZ: Optional[float] = None,
        F1: float = 0.02,
        F2: float = 1e-3,
        F3: float = 1e-5,
        E: float = 10.0,
        domE: float = 10.0,
        bit_cutoffs: Optional[str] = None,
        use_accelerator: bool = True,
        max_filter: bool = False,
        filter_stage: str = "ssv",
        bias_filter: bool = True,
        devices=None,
    ) -> None:
        self.profiles = list(profiles)
        self.Z = Z
        self.domZ = domZ
        self.F1 = F1
        self.F2 = F2
        self.F3 = F3
        # per-stage survivor counts / wall seconds / DP cells (L x M per
        # pair) of the last search() call — the bench reads these for
        # honest per-stage Gcells/s reporting.  On multi-device
        # searches ``stage_cells``/``stage_counts`` SUM across devices
        # while ``stage_seconds`` is the slowest device's wall (the
        # shards run concurrently), so ``cells/seconds`` is the
        # AGGREGATE rate of all ``stage_devices`` chips — divide by
        # ``stage_devices`` for a per-chip figure.
        self.stage_counts: Dict[str, int] = {}
        self.stage_seconds: Dict[str, float] = {}
        self.stage_cells: Dict[str, float] = {}
        self.stage_devices: int = 1
        self.E = E
        self.domE = domE
        if bit_cutoffs not in (None, "gathering", "noise", "trusted"):
            raise ValueError(f"invalid bit cutoffs: {bit_cutoffs!r}")
        self.bit_cutoffs = bit_cutoffs
        self.use_accelerator = use_accelerator
        self.max_filter = max_filter  # True = skip filters (hmmsearch --max)
        # composition bias filter null (p7_bg_FilterScore analog) for the
        # F1/F3 gates — on by default, like hmmsearch; reported scores
        # and E-values stay null1-based
        self.bias_filter = bias_filter
        self._logratio = None
        if filter_stage not in ("ssv", "msv"):
            raise ValueError(f"invalid filter stage: {filter_stage!r}")
        self.filter_stage = filter_stage
        # data parallelism over local devices: "all", a device list, or
        # None (single device).  Each device gets its own sub-pipeline
        # (device tensors built lazily under jax.default_device) and a
        # balanced sequence shard; one process then saturates a
        # multi-chip host (SURVEY §2.3 "data parallelism the workhorse")
        self.devices = devices
        self._subs: Optional[List["SearchPipeline"]] = None
        self._bank = ProfileBank.build(self.profiles) if self.profiles else None

    # -- helpers -----------------------------------------------------------

    def _cutoff(self, gm: SearchProfile) -> Optional[Tuple[float, float]]:
        if self.bit_cutoffs is None:
            return None
        key = {"gathering": "GA", "noise": "NC", "trusted": "TC"}[self.bit_cutoffs]
        cutoff = gm.hmm.cutoffs.get(key)
        if cutoff is None:
            raise ValueError(
                f"profile {gm.name!r} has no {key} bit cutoffs"
            )
        return cutoff

    # -- multi-device data parallelism --------------------------------------

    def _resolve_devices(self) -> Optional[List]:
        if self.devices is None:
            return None
        import jax

        devs = (list(jax.local_devices()) if self.devices == "all"
                else list(self.devices))
        if self.devices == "all" and len(devs) <= 1:
            return None          # nothing to pin or shard
        return devs or None      # explicit lists always honored

    def _search_multi(self, sequences, devices) -> List[SequenceHit]:
        """One search, sequences sharded over local devices.

        Every device runs the full per-stage stack on its shard inside
        its own thread under ``jax.default_device`` (thread-local), so
        all chips' kernels execute concurrently; results are re-indexed
        and merged in deterministic (sequence, profile) order.
        """
        import threading

        import jax

        from ..parallel import shard_sequences

        if self._subs is None:
            self._subs = []
            for _ in devices:
                sub = SearchPipeline(
                    [], Z=self.Z, domZ=self.domZ, F1=self.F1, F2=self.F2,
                    F3=self.F3, E=self.E, domE=self.domE,
                    bit_cutoffs=self.bit_cutoffs,
                    use_accelerator=self.use_accelerator,
                    max_filter=self.max_filter,
                    filter_stage=self.filter_stage,
                    bias_filter=self.bias_filter,
                )
                # share the host-side profile objects and packed bank;
                # device tensors build lazily on the sub's own device
                sub.profiles = self.profiles
                sub._bank = self._bank
                self._subs.append(sub)
        shards = shard_sequences(sequences, len(devices))
        Z = self.Z if self.Z is not None else float(len(sequences))
        results: List[Optional[List[SequenceHit]]] = [None] * len(devices)
        errors: List[BaseException] = []

        def work(d: int) -> None:
            try:
                idx = shards[d]
                if not idx:
                    results[d] = []
                    return
                sub = self._subs[d]
                sub.Z = Z
                sub.domZ = self.domZ if self.domZ is not None else Z
                with jax.default_device(devices[d]):
                    hits = sub.search([sequences[i] for i in idx])
                for hit in hits:
                    hit.sequence_index = idx[hit.sequence_index]
                results[d] = hits
            except BaseException as exc:  # surfaced after join
                errors.append(exc)

        threads = [
            threading.Thread(target=work, args=(d,)) for d in range(len(devices))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        order = {id(gm): p for p, gm in enumerate(self.profiles)}
        merged = [h for r in results if r for h in r]
        merged.sort(key=lambda h: (h.sequence_index, order[id(h.profile)]))
        # aggregate per-stage accounting across the shards that RAN
        # this call (a cached sub whose shard was empty still holds the
        # previous batch's numbers)
        self.stage_counts = {}
        self.stage_seconds = {}
        self.stage_cells = {}
        self.stage_devices = sum(1 for s in shards if s)
        for d, sub in enumerate(self._subs):
            if not shards[d]:
                continue
            for key, value in sub.stage_counts.items():
                self.stage_counts[key] = self.stage_counts.get(key, 0) + value
            for key, value in sub.stage_seconds.items():
                # slowest device = the stage's wall clock (shards run
                # concurrently); cells stay summed, so derived rates
                # are aggregate across stage_devices chips
                self.stage_seconds[key] = max(
                    self.stage_seconds.get(key, 0.0), value)
            for key, value in sub.stage_cells.items():
                self.stage_cells[key] = self.stage_cells.get(key, 0.0) + value
        return merged

    def _f3_e_gate(self, bits_all, bits_filt, tau, lam, Z):
        """Vectorized F3 (bias-filtered tail) + E-value gates.

        Shared by the stage-2 pre-prune and the stage-3 candidate
        selection so the two thresholds cannot drift apart.  Returns
        ``(pv_all, keep)``; the bit-cutoff branch (stage 3 only) is
        applied by the caller on top of ``keep``.
        """
        pv_all = _exp_surv_vec(bits_all, tau, lam)
        if self.max_filter:
            keep = numpy.ones(len(bits_all), dtype=bool)
        else:
            keep = _exp_surv_vec(bits_filt, tau, lam) <= self.F3
        if self.bit_cutoffs is None:
            keep &= pv_all * Z <= self.E
        return pv_all, keep

    def _xla_pair_scores(self, sequences, lengths, surviving, keys, scorer):
        """Bucketed XLA rescore of surviving pairs: ``(s, p, v)`` arrays.

        Sequences group by power-of-two length cap and go out in
        64-sequence chunks against the union sub-bank of their
        survivors; ``pad_to=cap`` pins ONE compiled shape per bucket
        (without it every chunk compiled at its own ``round_up(max
        len, 32)`` — review r5: up to dozens of shapes per bucket).
        """
        parts_s: List["numpy.ndarray"] = []
        parts_p: List["numpy.ndarray"] = []
        parts_v: List["numpy.ndarray"] = []
        by_cap: Dict[int, List[int]] = {}
        for i in keys:
            by_cap.setdefault(_pow2_cap(lengths[i]), []).append(i)
        for cap, group in sorted(by_cap.items()):
            for start in range(0, len(group), 64):
                chunk = group[start : start + 64]
                union = sorted({p for i in chunk for p in surviving[i]})
                sub = self._bank.select(union)
                scores = scorer(
                    sub, [sequences[i] for i in chunk], pad_to=cap)
                col = {p: c for c, p in enumerate(union)}
                for s, i in enumerate(chunk):
                    mine = numpy.asarray(surviving[i], dtype=numpy.int64)
                    parts_s.append(numpy.full(len(mine), i, dtype=numpy.int64))
                    parts_p.append(mine)
                    parts_v.append(
                        scores[s, [col[p] for p in mine]].astype(numpy.float64))
        if not parts_s:
            z = numpy.zeros(0)
            return z.astype(numpy.int64), z.astype(numpy.int64), z
        return (numpy.concatenate(parts_s), numpy.concatenate(parts_p),
                numpy.concatenate(parts_v))

    # -- search ------------------------------------------------------------

    def search(self, sequences: Sequence["numpy.ndarray"]) -> List[SequenceHit]:
        """Search all profiles against all encoded sequences."""
        if not self.profiles or not sequences:
            # reset the accounting so an empty call never reports the
            # previous batch's numbers
            self.stage_counts = {}
            self.stage_seconds = {}
            self.stage_cells = {}
            self.stage_devices = 1
            return []
        devices = self._resolve_devices()
        if devices is not None and len(devices) > 1 and len(sequences) > 1:
            return self._search_multi(sequences, devices)
        if devices:
            # an explicit device list with one effective device (or a
            # 1-sequence batch) still pins placement — previously it
            # was silently ignored and work landed on the default
            # device the caller may have been avoiding
            import jax

            previous = self.devices
            self.devices = None
            try:
                with jax.default_device(devices[0]):
                    return self.search(sequences)
            finally:
                self.devices = previous
        Z = self.Z if self.Z is not None else float(len(sequences))
        domZ = self.domZ if self.domZ is not None else Z
        lengths = numpy.array([len(x) for x in sequences])
        nullsc = numpy.array([null1_score(int(L)) for L in lengths])

        # composition bias filter null (F1/F3 gates only)
        use_bias = self.bias_filter and not self.max_filter
        counts = None
        extra_mx = None
        if use_bias:
            if self._logratio is None:
                self._logratio = bias_logratio(self._bank).astype(numpy.float64)
            counts = numpy.zeros((len(sequences), 20), dtype=numpy.float64)
            for i, x in enumerate(sequences):
                counts[i] = numpy.bincount(
                    numpy.minimum(x, 20), minlength=21
                )[:20]
            if len(sequences) * self._bank.P <= 64_000_000:
                # one BLAS matmul beats per-pair gathers by ~50x
                # (clipped at >=0 — see filter_extra)
                extra_mx = numpy.maximum(numpy.logaddexp(
                    0.0, counts @ self._logratio
                ) - LOG2, 0.0)

        def filter_extra(s_arr, p_arr):
            """``filtersc - nullsc`` (nats) per pair; 0 without bias."""
            if not use_bias:
                return numpy.zeros(len(s_arr))
            if extra_mx is not None:
                return extra_mx[s_arr, p_arr]
            delta = numpy.einsum(
                "sk,ks->s", counts[s_arr], self._logratio[:, p_arr]
            )
            # clipped at >=0: HMMER's 2-state filter HMM can always take
            # the all-null1 path, so its filter score never drops BELOW
            # null1 — without the clip every pair gains ~1 free bit and
            # the F1 pass rate balloons to 2-3x the calibrated 2%
            return numpy.maximum(numpy.logaddexp(0.0, delta) - LOG2, 0.0)

        # ---- stage 1 (device): SSV/MSV filter of all pairs
        pair_scores: Dict[Tuple[int, int], float] = {}
        surviving: Dict[int, List[int]] = {}
        model_lengths = self._bank.lengths.astype(numpy.float64)

        def pair_cells(surv: Dict[int, List[int]]) -> float:
            return float(sum(
                lengths[i] * model_lengths[profs].sum()
                for i, profs in surv.items()
            ))

        self.stage_seconds = {}
        self.stage_cells = {}
        self.stage_devices = 1
        t_stage = time.perf_counter()

        if self.max_filter or not self.use_accelerator:
            for i in range(len(sequences)):
                surviving[i] = list(range(len(self.profiles)))
        else:
            order = numpy.argsort(lengths, kind="stable")
            bucket: List[int] = []

            def flush(bucket: List[int]) -> None:
                if not bucket:
                    return
                seqs = [sequences[i] for i in bucket]
                scorer = ssv_scores if self.filter_stage == "ssv" else msv_scores
                scores = scorer(self._bank, seqs, pad_to=current_cap)  # [S, P] nats
                null = nullsc[bucket][:, None]
                if use_bias:
                    delta = counts[bucket] @ self._logratio  # [bS, P]
                    null = null + numpy.maximum(
                        numpy.logaddexp(0.0, delta) - LOG2, 0.0)
                bits = (scores - null) / LOG2
                lam = self._bank.msv_lambda[None, :]
                mu = self._bank.msv_mu[None, :]
                pv = _gumbel_surv_vec(lam * (bits - mu))
                keep = pv <= self.F1
                for s, i in enumerate(bucket):
                    kept = numpy.nonzero(keep[s])[0].tolist()
                    if kept:
                        surviving[i] = kept

            current_cap: Optional[int] = None
            for i in order:
                cap = _pow2_cap(lengths[i])
                if current_cap is None:
                    current_cap = cap
                if cap != current_cap or len(bucket) >= 256:
                    flush(bucket)
                    bucket = []
                    current_cap = cap
                bucket.append(int(i))
            flush(bucket)

        self.stage_seconds["filter"] = time.perf_counter() - t_stage
        # cells are only charged when the filter actually scored the
        # all-pairs matrix; --max / host mode skip it (review r5: the
        # bench printed an absurd Gcells/s for a stage that did no work)
        filter_ran = not (self.max_filter or not self.use_accelerator)
        self.stage_cells["filter"] = (
            float(lengths.sum()) * model_lengths.sum() if filter_ran else 0.0)

        # ---- stage 1.5 (device): Viterbi F2 gate on filter survivors
        # (hmmsearch runs MSV -> bias -> Viterbi -> Forward; skipping the
        # Viterbi gate would report pairs hmmsearch drops)
        self.stage_counts = {
            "pairs": len(sequences) * len(self.profiles),
            "F1": sum(len(v) for v in surviving.values()),
        }
        t_stage = time.perf_counter()
        self.stage_cells["viterbi"] = pair_cells(surviving)
        if surviving and not self.max_filter and self.use_accelerator:
            keys = sorted(surviving)
            s_arr, p_arr, v_arr = self._xla_pair_scores(
                sequences, lengths, surviving, keys, viterbi_scores)
            bits = (v_arr.astype(numpy.float64) - nullsc[s_arr]) / LOG2
            bits -= filter_extra(s_arr, p_arr) / LOG2
            lam = self._bank.vit_lambda[p_arr]
            mu = self._bank.vit_mu[p_arr]
            pv = _gumbel_surv_vec(lam * (bits - mu))
            keep = pv <= self.F2
            surviving = {}
            for s, p in zip(s_arr[keep], p_arr[keep]):
                surviving.setdefault(int(s), []).append(int(p))

        self.stage_seconds["viterbi"] = time.perf_counter() - t_stage

        # ---- stage 2 (device): Forward rescore of surviving pairs
        keys = sorted(surviving)
        self.stage_counts["F2"] = sum(len(v) for v in surviving.values())
        t_stage = time.perf_counter()
        self.stage_cells["forward"] = pair_cells(surviving)
        if not keys:
            return []
        if not self.use_accelerator:
            for i in keys:
                for p in surviving[i]:
                    pair_scores[(i, p)] = engine.forward(
                        self.profiles[p], sequences[i]
                    ).score
        else:
            # batch × profile-union per length bucket
            s2, p2, v2 = self._xla_pair_scores(
                sequences, lengths, surviving, keys, forward_scores)
            for s, p, v in zip(s2, p2, v2):
                pair_scores[(int(s), int(p))] = float(v)

        self.stage_seconds["forward"] = time.perf_counter() - t_stage
        t_stage = time.perf_counter()

        # ---- stage 3: Forward threshold, domain definition, reporting.
        # Candidate selection first (F3 / E / bit-cutoff gates),
        # vectorized — a per-pair Python loop here held the host for
        # ~0.3 s per genome-sized batch while the device sat idle
        candidates: List[Tuple[int, int, float, float]] = []
        items = sorted(pair_scores.items())
        if items:
            ip = numpy.asarray([k for k, _v in items], dtype=numpy.int64)
            vals = numpy.asarray([v for _k, v in items], dtype=numpy.float64)
            extras = filter_extra(ip[:, 0], ip[:, 1]) / LOG2
            bits_all = (vals - nullsc[ip[:, 0]]) / LOG2
            tau = self._bank.fwd_tau[ip[:, 1]].astype(numpy.float64)
            lam = self._bank.fwd_lambda[ip[:, 1]].astype(numpy.float64)

            pv_all, keep = self._f3_e_gate(
                bits_all, bits_all - extras, tau, lam, Z)
            if self.bit_cutoffs is not None:
                # evaluate cutoffs only for F3 passers — a profile
                # without the requested cutoff line must not fail a
                # search whose gated pairs never reach reporting
                kept = numpy.flatnonzero(keep)
                ga = numpy.asarray([
                    self._cutoff(self.profiles[p])[0] for p in ip[kept, 1]
                ])
                keep[kept] &= bits_all[kept] >= ga
            candidates = [
                (int(i), int(p), float(b), float(v))
                for (i, p), b, v in zip(
                    ip[keep], bits_all[keep], pv_all[keep])
            ]
        self.stage_counts["F3"] = len(candidates)
        if not candidates:
            return []

        # Domain definition on the exact float64 host engine.
        domains_of: Dict[Tuple[int, int], List[DomainHit]] = {}
        rescored: List[Tuple[int, int, float, float]] = []
        for i, p, _, _ in candidates:
            gm = self.profiles[p]
            x = sequences[i]
            fwd = engine.forward(gm, x)
            bits64 = (fwd.score - nullsc[i]) / LOG2
            tau, lam = gm.hmm.stats.get("FORWARD", (0.0, math.log(2.0)))
            pv64 = exp_surv(bits64, tau, lam)
            # re-apply the reporting gates to the float64 rescore:
            # the f32 gate above admitted the pair, but at a
            # threshold the f64 value can land outside the
            # contract (review r5: an f32 evalue of 9.999 whose
            # f64 value is 10.002 was reported with E > 10)
            if self.bit_cutoffs is not None:
                cutoff = self._cutoff(gm)
                if cutoff is not None and bits64 < cutoff[0]:
                    continue
            else:
                bits_filt = bits64 - float(filter_extra(
                    numpy.asarray([i]), numpy.asarray([p]))[0]) / LOG2
                if not self.max_filter and exp_surv(
                        bits_filt, tau, lam) > self.F3:
                    continue
                if pv64 * Z > self.E:
                    continue
            domains_of[(i, p)] = engine.define_domains(gm, x, fwd)
            # keep the float64 rescore for reporting on this path
            rescored.append((i, p, bits64, pv64))
        candidates = rescored

        hits: List[SequenceHit] = []
        for i, p, bits, pv in candidates:
            gm = self.profiles[p]
            cutoff = self._cutoff(gm)
            reported: List[DomainHit] = []
            for dom in domains_of.get((i, p), []):
                dom.i_evalue = dom.pvalue * domZ
                if cutoff is None:
                    if dom.i_evalue <= self.domE:
                        reported.append(dom)
                elif dom.bitscore >= cutoff[1]:
                    reported.append(dom)
            if not reported:
                continue
            hits.append(SequenceHit(
                sequence_index=i, profile=gm,
                score=float(bits), pvalue=float(pv), evalue=float(pv) * Z,
                domains=reported,
            ))
        self.stage_counts["reported"] = len(hits)
        self.stage_seconds["domains"] = time.perf_counter() - t_stage
        self.stage_cells["domains"] = float(sum(
            lengths[i] * model_lengths[p] for i, p, _, _ in candidates
        ))
        return hits

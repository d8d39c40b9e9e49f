"""Profile-HMM engine and pipeline tests (seeded synthetic bank).

Replicates the reference's pyhmmer test contract
(``/root/reference/tests/test_hmmer/test_pyhmmer.py:38-47``: 3 of 3
fixture proteins annotated; whitelisting one accession → 1) on a seeded,
calibrated 10-profile bank written as ``.h3m`` and three proteins that
each carry a planted copy of one profile.  It adds the kernel-level
parity harness the reference lacks: the batched JAX engines and the SSV
kernel (in interpret mode) are tested against the float64 host engine,
and the host engine against brute-force enumeration on a tiny
hand-built model.
"""

import itertools
import math

import numpy
import pytest

from gecco_tpu import seqio
from gecco_tpu.hmm import HMM, ProfileHMMAnnotator, embedded_hmms
from gecco_tpu.hmm import batch, engine
from gecco_tpu.hmm.io import AMINO_ALPHABET, BACKGROUND_F, ProfileHMM, encode_sequence, parse_hmmer3
from gecco_tpu.hmm.pipeline import SearchPipeline
from gecco_tpu.hmm.profile import configure_local, length_model, match_occupancy, null1_score
from gecco_tpu.model import Gene, Protein, Strand
from gecco_tpu.seq import Seq, SeqRecord

N_BANK = 10
PLANTED = ("PF90000", "PF90001", "PF90003")   # profile planted in protein i


@pytest.fixture(scope="module")
def bank_file(tmp_path_factory):
    """A calibrated 10-profile bank written through ``h3m.write_h3m``."""
    from gecco_tpu.hmm.calibrate import calibrate
    from gecco_tpu.hmm.h3m import write_h3m
    from gecco_tpu.hmm.synthetic import synthetic_profiles

    bank = synthetic_profiles(N_BANK, min_length=30, max_length=120, seed=101)
    for p, gm in enumerate(bank):
        gm.hmm.name = f"SYN{p}"
        gm.hmm.accession = f"PF9{p:04d}.1"
    calibrate(bank, n=200, L=200, seed=3)
    path = tmp_path_factory.mktemp("bank") / "bank.h3m"
    write_h3m(str(path), [gm.hmm for gm in bank])
    return str(path)


@pytest.fixture(scope="module")
def profiles(bank_file):
    return [configure_local(p) for p in parse_hmmer3(bank_file)]


@pytest.fixture(scope="module")
def protein_file(tmp_path_factory, profiles):
    """Three background proteins, each with a planted, 10%-diverged
    copy of one bank profile, written as FASTA."""
    from gecco_tpu.hmm.synthetic import plant_domain, synthetic_proteins

    by_acc = {gm.accession.split(".")[0]: gm for gm in profiles}
    rng = numpy.random.default_rng(5)
    records = []
    for i, (acc, x) in enumerate(zip(
            PLANTED, synthetic_proteins(3, mean_length=260, seed=7))):
        x = numpy.concatenate([x, x])[:max(len(x), 200)]
        gm = by_acc[acc]
        x = plant_domain(x, gm, rng, offset=15, max_len=gm.M, divergence=0.1)
        seq = "".join(AMINO_ALPHABET[r] for r in x)
        records.append(SeqRecord(id=f"prot{i + 1}", seq=Seq(seq)))
    path = tmp_path_factory.mktemp("proteins") / "proteins.faa"
    with open(path, "w") as handle:
        seqio.write_fasta(records, handle)
    return str(path)


@pytest.fixture(scope="module")
def sequences(protein_file):
    return [
        (record.id, encode_sequence(str(record.seq)))
        for record in seqio.parse(protein_file)
    ]


def test_parse_synthetic_bank(bank_file):
    raw = list(parse_hmmer3(bank_file))
    assert len(raw) == N_BANK
    assert raw[0].accession == "PF90000.1"
    assert raw[0].name == "SYN0"
    assert 30 <= raw[0].length <= 120
    assert set(raw[0].stats) >= {"MSV", "VITERBI", "FORWARD"}
    assert raw[0].stats["MSV"][1] == pytest.approx(math.log(2.0), abs=1e-6)
    # emission and transition rows are normalized probability distributions
    for p in raw:
        assert numpy.allclose(p.match[1:].sum(axis=1), 1.0, atol=1e-4)
        assert numpy.allclose(p.trans[1:-1, :3].sum(axis=1), 1.0, atol=1e-4)


def test_occupancy_and_entry(profiles):
    for gm in profiles:
        occ = match_occupancy(gm.hmm)
        assert ((occ[1:] >= 0) & (occ[1:] <= 1)).all()
        # entry distribution sums to <= 1 over start positions
        entry = numpy.exp(gm.bm[1:])
        assert entry.sum() <= 1.0 + 1e-9


def test_forward_equals_backward(profiles, sequences):
    gm = profiles[0]
    _, x = sequences[0]
    f = engine.forward(gm, x)
    b = engine.backward(gm, x)
    assert f.score == pytest.approx(b.score, abs=1e-8)


def test_forward_dominates_viterbi_dominates_nothing(profiles, sequences):
    gm = profiles[0]
    _, x = sequences[0]
    fwd = engine.forward(gm, x).score
    vit = engine.viterbi_score(gm, x)
    assert fwd >= vit


def test_posteriors_sum_to_one(profiles, sequences):
    gm = profiles[0]
    _, x = sequences[0]
    f, b = engine.forward(gm, x), engine.backward(gm, x)
    post = engine.posterior_decode(gm, x, f, b)
    # each emitted residue is accounted for: core model + NJC mass == 1
    core = post.ppM[1:].sum(axis=1) + post.ppI[1:].sum(axis=1)
    total = core + (1.0 - post.mocc[1:])
    assert numpy.allclose(total, 1.0, atol=1e-6)


def _toy_profile():
    """A tiny 3-node HMM for brute-force validation."""
    rng = numpy.random.default_rng(7)
    M = 3
    match = numpy.zeros((M + 1, 20))
    insert = numpy.zeros((M + 1, 20))
    trans = numpy.zeros((M + 1, 7))
    for k in range(M + 1):
        match[k] = rng.dirichlet(numpy.ones(20))
        insert[k] = BACKGROUND_F
        mm = rng.dirichlet(numpy.ones(3) * 5)
        im = rng.dirichlet(numpy.ones(2) * 5)
        dm = rng.dirichlet(numpy.ones(2) * 5)
        trans[k] = [mm[0], mm[1], mm[2], im[0], im[1], dm[0], dm[1]]
    trans[M] = [1.0, 0.0, 0.0, 0.5, 0.5, 1.0, 0.0]
    return ProfileHMM(
        name="toy", accession="TOY00001", description=None, length=M,
        alphabet="amino", match=match, insert=insert, trans=trans,
        stats={"MSV": (-5.0, 0.7), "VITERBI": (-5.0, 0.7), "FORWARD": (-3.0, 0.7)},
    )


def _brute_force_forward(gm, x):
    """Exact path enumeration of the full local multihit state machine."""
    L, M = len(x), gm.M
    loop, move = length_model(L)
    paths = []

    def go(state, k, i, logp):
        # state ∈ {N, B, M, I, D, E, J, C}; i residues consumed so far
        if logp == -numpy.inf:
            return
        if state == "N":
            if i < L:
                go("N", 0, i + 1, logp + loop)
            go("B", 0, i, logp + move)
        elif state == "B":
            if i < L:
                for k2 in range(1, M + 1):
                    go("M", k2, i + 1, logp + gm.bm[k2] + gm.msc[k2, x[i]])
        elif state == "M":
            go("E", 0, i, logp)  # free local exit
            if k < M:
                if i < L:
                    go("M", k + 1, i + 1, logp + gm.tmm[k] + gm.msc[k + 1, x[i]])
                    go("I", k, i + 1, logp + gm.tmi[k])
                go("D", k + 1, i, logp + gm.tmd[k])
        elif state == "I":
            if i < L:
                go("M", k + 1, i + 1, logp + gm.tim[k] + gm.msc[k + 1, x[i]])
                go("I", k, i + 1, logp + gm.tii[k])
        elif state == "D":
            go("E", 0, i, logp)  # D -> E free in local mode
            if k < M:
                if i < L:
                    go("M", k + 1, i + 1, logp + gm.tdm[k] + gm.msc[k + 1, x[i]])
                go("D", k + 1, i, logp + gm.tdd[k])
        elif state == "E":
            go("J", 0, i, logp + gm.loop_e)
            go("C", 0, i, logp + gm.move_e)
        elif state == "J":
            if i < L:
                go("J", 0, i + 1, logp + loop)
            go("B", 0, i, logp + move)
        elif state == "C":
            if i < L:
                go("C", 0, i + 1, logp + loop)
            elif i == L:
                paths.append(logp + move)  # C -> T

    go("N", 0, 0, 0.0)
    return numpy.logaddexp.reduce(numpy.array(paths))


def test_forward_matches_brute_force():
    """Exact enumeration over every path equals the Forward DP."""
    raw = _toy_profile()
    gm = configure_local(raw)
    x = numpy.array([3, 7, 1, 0], dtype=numpy.int32)
    enumerated = _brute_force_forward(gm, x)
    full = engine.forward(gm, x).score
    assert full == pytest.approx(enumerated, abs=1e-9)


def test_batch_forward_matches_engine(profiles, sequences):
    bank = batch.ProfileBank.build(profiles)
    xs = [x for _, x in sequences]
    scores = batch.forward_scores(bank, xs)
    for s, x in enumerate(xs):
        for p, gm in enumerate(profiles):
            reference = engine.forward(gm, x).score
            assert scores[s, p] == pytest.approx(reference, abs=5e-3), (s, p)


def test_batch_msv_matches_engine(profiles, sequences):
    bank = batch.ProfileBank.build(profiles)
    xs = [x for _, x in sequences]
    scores = batch.msv_scores(bank, xs)
    for s, x in enumerate(xs):
        for p, gm in enumerate(profiles):
            reference = engine.msv_score(gm, x)
            assert scores[s, p] == pytest.approx(reference, abs=5e-3), (s, p)


def test_ssv_score_below_msv_and_matches_batch(profiles, sequences):
    """SSV (single segment) ≤ MSV per pair; batch engine matches host."""
    bank = batch.ProfileBank.build(profiles)
    xs = [x for _, x in sequences]
    scores = batch.ssv_scores(bank, xs)
    for s, x in enumerate(xs):
        for p, gm in enumerate(profiles):
            reference = engine.ssv_score(gm, x)
            assert scores[s, p] == pytest.approx(reference, abs=5e-3), (s, p)
            assert reference <= engine.msv_score(gm, x) + 1e-9


def test_ssv_kernel_matches_host(profiles, sequences):
    """The Triton SSV kernel (interpret mode) equals the float64 host
    engine on every pair, with ragged lengths, a 3-residue sequence and
    an empty one (which scores -inf, as on the host)."""
    from gecco_tpu.hmm.ssv import ssv_scores_pallas

    bank = batch.ProfileBank.build(profiles)
    xs = [x for _, x in sequences]
    xs = xs + [xs[0][:3], numpy.zeros(0, dtype=numpy.int32), xs[1][:77]]
    scores = ssv_scores_pallas(bank, xs, interpret=True)
    assert scores.shape == (len(xs), len(profiles))
    for s, x in enumerate(xs):
        for p, gm in enumerate(profiles):
            reference = engine.ssv_score(gm, x)
            if len(x) == 0:
                assert scores[s, p] == reference == -numpy.inf
            else:
                assert scores[s, p] == pytest.approx(reference, abs=1e-4), (s, p)


def test_ssv_kernel_work_table_covers_every_diagonal():
    """Each profile gets exactly the diagonal blocks that hold a cell:
    diagonals -(Lp-1) .. M-1, none past the profile's true length."""
    from gecco_tpu.hmm.ssv import BD, _work_table

    lengths = numpy.array([1, 31, 32, 33, 200], dtype=numpy.int32)
    Lp = 96
    wp, wb = _work_table(lengths, Lp)
    assert list(wp) == sorted(wp)        # segment_max needs sorted segments
    for p, M in enumerate(lengths):
        blocks = wb[wp == p]
        assert list(blocks) == list(range(len(blocks)))
        first = blocks.min() * BD - (Lp - 1)
        last = blocks.max() * BD - (Lp - 1) + BD - 1
        assert first == -(Lp - 1)
        assert M - 1 <= last < M - 1 + BD


def test_ssv_kernel_pads_batch_to_tiles(profiles, sequences):
    """Batches that are not a multiple of the row tile, and a caller's
    ``pad_to``, leave scores unchanged."""
    from gecco_tpu.hmm.ssv import BS, ssv_scores_pallas

    bank = batch.ProfileBank.build(profiles[:3])
    xs = [x for _, x in sequences][:2]
    assert len(xs) % BS
    plain = ssv_scores_pallas(bank, xs, interpret=True)
    padded = ssv_scores_pallas(bank, xs, pad_to=512, interpret=True)
    assert plain.shape == (2, 3)
    numpy.testing.assert_allclose(plain, padded, atol=1e-5)


def test_ssv_scores_chooses_kernel_on_gpu(profiles, sequences, monkeypatch):
    """``batch.ssv_scores`` is the one place the filter engine is chosen:
    the kernel on a GPU, XLA's engine elsewhere, never interpret mode."""
    import jax

    from gecco_tpu.hmm import ssv

    bank = batch.ProfileBank.build(profiles)
    xs = [x for _, x in sequences]
    numpy.testing.assert_array_equal(
        batch.ssv_scores(bank, xs), batch.ssv_scores_xla(bank, xs))
    calls = []

    def fake(bank, sequences, pad_to=None, interpret=False):
        calls.append(interpret)
        return "kernel"

    monkeypatch.setattr(ssv, "ssv_scores_pallas", fake)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert batch.ssv_scores(bank, xs) == "kernel"
    assert calls == [False]


@pytest.mark.gpu
def test_ssv_kernel_compiled_matches_host(gpu, profiles, sequences):
    """The kernel as Triton compiles it for the card equals the host."""
    from gecco_tpu.hmm.ssv import ssv_scores_pallas

    bank = batch.ProfileBank.build(profiles)
    xs = [x for _, x in sequences]
    scores = ssv_scores_pallas(bank, xs)
    for s, x in enumerate(xs):
        for p, gm in enumerate(profiles):
            assert scores[s, p] == pytest.approx(
                engine.ssv_score(gm, x), abs=1e-4), (s, p)


def test_xla_engines_split_under_plane_budget(profiles, sequences, monkeypatch):
    """A dispatch whose DP plane would exceed ``PLANE_BYTES`` is split
    into sequence chunks; every score stays the same."""
    bank = batch.ProfileBank.build(profiles)
    xs = [x for _, x in sequences]
    whole = {name: getattr(batch, name)(bank, xs) for name in
             ("forward_scores", "viterbi_scores", "ssv_scores_xla")}
    monkeypatch.setattr(batch, "PLANE_BYTES", 4 * bank.P * bank.Mp)
    for name, expected in whole.items():
        numpy.testing.assert_allclose(
            getattr(batch, name)(bank, xs), expected, atol=1e-5, err_msg=name)


def test_pipeline_reports_expected_hits(profiles, sequences):
    pipeline = SearchPipeline(profiles, Z=10, domZ=10)
    hits = pipeline.search([x for _, x in sequences])
    strong = {(h.sequence_index, h.profile.accession.split(".")[0]) for h in hits if h.evalue < 1e-6}
    assert strong == set(enumerate(PLANTED))
    for hit in hits:
        for dom in hit.domains:
            assert 1 <= dom.target_from <= dom.target_to
            assert 1 <= dom.hmm_from <= dom.hmm_to <= hit.profile.M
            assert dom.i_evalue == pytest.approx(dom.pvalue * 10)


def test_annotator_contract(bank_file, protein_file):
    """The reference test contract: 3 genes annotated; whitelist → 1."""
    records = list(seqio.parse(protein_file))
    hmm = HMM(
        id="Pfam", version="vX.Y", url="http://example.com",
        path=bank_file, size=10, relabel_with=r"s/(PF\d+).\d+/\1/",
    )

    def make_genes():
        return [
            Gene(r, 1, len(str(r.seq)) * 3 + 1, Strand.Coding, Protein(r.id, r.seq))
            for r in records
        ]

    annotator = ProfileHMMAnnotator(hmm, cpus=1)
    genes = annotator.run(make_genes())
    assert sum(1 for g in genes if g.protein.domains) == 3

    annotator = ProfileHMMAnnotator(hmm, cpus=1, whitelist={PLANTED[0]})
    genes = annotator.run(make_genes())
    assert sum(1 for g in genes if g.protein.domains) == 1
    domain = next(g for g in genes if g.protein.domains).protein.domains[0]
    assert domain.name == PLANTED[0]
    assert domain.hmm == "Pfam"
    assert domain.i_evalue < 1e-9


def test_annotator_records_search_stage_times(bank_file, protein_file):
    """Each search adds its per-stage wall seconds to the CLI's stage
    timer (``run -vv`` prints them as ``search-<stage>``)."""
    from gecco_tpu.profiling import TIMER

    records = list(seqio.parse(protein_file))
    genes = [
        Gene(r, 1, len(str(r.seq)) * 3 + 1, Strand.Coding, Protein(r.id, r.seq))
        for r in records
    ]
    hmm = HMM(id="Pfam", version="vX.Y", url="", path=bank_file, size=10)
    TIMER.reset()
    ProfileHMMAnnotator(hmm, cpus=1).run(genes)
    stages = TIMER.summary()
    assert {"search-filter", "search-viterbi", "search-forward",
            "search-domains"} <= set(stages)
    assert all(calls == 1 and seconds >= 0.0
               for name, (calls, seconds) in stages.items())


def test_calibration_fits_background_statistics(profiles):
    """hmmbuild-style calibration: after fitting, the designed filter
    pass rate of random background sequences matches the requested
    P-value within sampling error, and reported Forward P-values are
    roughly uniform (unbiased E-values)."""
    from gecco_tpu.hmm import batch
    from gecco_tpu.hmm.calibrate import calibrate
    from gecco_tpu.hmm.profile import null1_score
    from gecco_tpu.hmm.synthetic import synthetic_profiles

    import math

    bank_profiles = synthetic_profiles(12, min_length=30, max_length=80, seed=3)
    calibrate(bank_profiles, n=200, L=128, seed=5)
    bank = batch.ProfileBank.build(bank_profiles)

    rng = numpy.random.default_rng(11)
    from gecco_tpu.hmm.io import BACKGROUND_F

    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    xs = [rng.choice(20, size=128, p=p_bg).astype(numpy.int32) for _ in range(100)]
    scores = numpy.asarray(batch.ssv_scores(bank, xs))
    bits = (scores - null1_score(128)) / math.log(2.0)
    y = bank.msv_lambda[None, :] * (bits - bank.msv_mu[None, :])
    pv = 1.0 - numpy.exp(-numpy.exp(-numpy.clip(y, -30, 30)))
    # designed pass rate 10%: the empirical rate should be in the
    # same ballpark (fresh draws, 1200 trials)
    rate = float((pv <= 0.10).mean())
    assert 0.03 < rate < 0.3, rate


def test_bias_filter_demotes_compositional_matches(profiles, sequences):
    """The composition bias filter (p7_bg_FilterScore analog) kills
    low-complexity/compositionally-biased filter passes but keeps real
    structural hits.

    The decoy is a shuffled planted domain: residues genuinely emitted
    from a profile's match states, then permuted — identical composition
    (so the bias null fires) but no positional signal beyond chance
    diagonals.  The F1 gate must pass it WITHOUT the bias correction
    and reject it WITH the correction.
    """
    import math

    xs = [x for _, x in sequences]
    from gecco_tpu.hmm import batch
    from gecco_tpu.hmm.batch import bias_logratio
    from gecco_tpu.hmm.profile import null1_score

    bank = batch.ProfileBank.build(profiles)
    lr = bias_logratio(bank)
    assert lr.shape == (20, bank.P)

    def f1_pvalues(x, with_bias):
        scores = numpy.asarray(batch.ssv_scores(bank, [x]))[0]
        nullsc = null1_score(len(x))
        if with_bias:
            counts = numpy.bincount(
                numpy.minimum(x, 20), minlength=21
            )[:20].astype(numpy.float64)
            nullsc = nullsc + (
                numpy.logaddexp(0.0, counts @ lr) - math.log(2.0)
            )
        bits = (scores - nullsc) / math.log(2.0)
        y = bank.msv_lambda * (bits - bank.msv_mu)
        return 1.0 - numpy.exp(-numpy.exp(-numpy.clip(y, -30.0, 30.0)))

    # search over seeds for a shuffle that still rides the F1 gate on
    # composition alone (diagonal max of a shuffled domain is noisy)
    target = None
    for seed in range(40):
        rng = numpy.random.default_rng(seed)
        for p_idx, gm in enumerate(profiles):
            probs = numpy.asarray(gm.hmm.match[1 : gm.M + 1], numpy.float64)
            probs = probs / probs.sum(axis=1, keepdims=True)
            emit = numpy.stack(
                [rng.choice(20, p=probs[k]) for k in range(gm.M)]
            ).astype(numpy.int32)
            decoy = numpy.asarray(rng.permutation(emit), dtype=numpy.int32)
            pv_plain = f1_pvalues(decoy, with_bias=False)[p_idx]
            pv_bias = f1_pvalues(decoy, with_bias=True)[p_idx]
            if pv_plain <= 0.02 < pv_bias:
                target = (decoy, p_idx, pv_plain, pv_bias)
                break
        if target is not None:
            break
    assert target is not None, (
        "no shuffled-domain decoy demoted by the bias filter in 40 seeds"
    )

    # end-to-end: real structural hits survive the bias filter
    hits_bias = SearchPipeline(profiles, Z=10, domZ=10).search(xs)
    hits_nobias = SearchPipeline(
        profiles, Z=10, domZ=10, bias_filter=False
    ).search(xs)
    strong = lambda hs: {
        (h.sequence_index, h.profile.accession.split(".")[0])
        for h in hs if h.evalue < 1e-6
    }
    assert strong(hits_bias) == strong(hits_nobias) == set(enumerate(PLANTED))


def test_viterbi_engines_agree(profiles, sequences):
    """Viterbi (F2) scores agree host <-> XLA, on the whole bank and on
    a union sub-bank as the F2 rescore builds it."""
    from gecco_tpu.hmm.batch import ProfileBank, viterbi_scores

    xs = [x for _, x in sequences]
    bank = ProfileBank.build(profiles)
    host = numpy.array(
        [[engine.viterbi_score(gm, x) for gm in profiles] for x in xs])
    xla = viterbi_scores(bank, xs)
    assert numpy.abs(host - xla).max() < 5e-3
    union = [1, 4, 7]
    sub = viterbi_scores(bank.select(union), xs, pad_to=512)
    assert numpy.abs(host[:, union] - sub).max() < 5e-3


def test_pipeline_f2_stage_gates_and_counts(profiles, sequences):
    """The pipeline runs SSV -> Viterbi(F2) -> Forward with monotone
    survivor counts, and an impossibly strict F2 kills every pair."""
    xs = [x for _, x in sequences]
    pipeline = SearchPipeline(profiles, Z=10, domZ=10)
    hits = pipeline.search(xs)
    counts = pipeline.stage_counts
    assert counts["pairs"] == len(xs) * len(profiles)
    assert counts["pairs"] >= counts["F1"] >= counts["F2"] >= counts["F3"]
    assert counts["reported"] == len(hits) > 0

    strict = SearchPipeline(profiles, Z=10, domZ=10, F2=1e-300)
    assert strict.search(xs) == []
    assert strict.stage_counts["F2"] == 0

    # gate respects the Viterbi P-value: loosening F2 to 1 changes
    # nothing for the real hits (they pass at the default too)
    loose = SearchPipeline(profiles, Z=10, domZ=10, F2=1.0)
    loose_hits = loose.search(xs)
    assert {(h.sequence_index, h.profile.name) for h in hits} <= {
        (h.sequence_index, h.profile.name) for h in loose_hits}


def test_parse_hmmer3_rejects_binary(tmp_path):
    """Pressed binary HMM input fails with a clear error, not garbage."""
    path = tmp_path / "bank.h3m"
    path.write_bytes(b"\xe8\xb3\xe6\x3f" + bytes(range(256)) * 4)
    with pytest.raises(ValueError, match="binary HMMER file"):
        list(parse_hmmer3(str(path)))


# -- multi-domain stress parity (VERDICT r2 item 5) -------------------------
#
# Repeat-protein workloads: 2-3 planted copies of the same profile per
# sequence.  Region finding, envelope splitting, null2, per-domain
# i-evalues and alignments must agree host <-> device pipeline.  Known
# deviation: envelope *splitting* uses deterministic expected-B
# crossings (engine._split_region) where HMMER clusters stochastic
# tracebacks — all engines HERE share that algorithm, so the parity
# asserted is internal consistency plus count-correctness on planted
# fixtures (docs/parity.md known-deviation #3 documents the HMMER-side
# divergence).


@pytest.fixture(scope="module")
def multidomain_workload():
    from gecco_tpu.hmm.calibrate import calibrate
    from gecco_tpu.hmm.synthetic import (
        plant_domain, synthetic_profiles, synthetic_proteins)

    profiles = synthetic_profiles(6, min_length=40, max_length=80, seed=21)
    calibrate(profiles, n=160, L=160, seed=5)
    rng = numpy.random.default_rng(11)
    seqs = [x[:448] for x in synthetic_proteins(8, mean_length=400, seed=13)]
    planted = {}
    for i in range(len(seqs)):
        gm = profiles[i % len(profiles)]
        copies = 2 + (i % 2)
        x = seqs[i]
        stride = max(gm.M + 30, len(x) // (copies + 1))
        n_planted = 0
        for c in range(copies):
            off = 12 + c * stride
            if off + gm.M + 10 < len(x):
                # strong homologs (15% divergence): every copy must be
                # individually detectable so the envelope SPLIT is what
                # the test exercises, not marginal detection
                x = plant_domain(x, gm, rng, offset=off, max_len=gm.M,
                                 divergence=0.15)
                n_planted += 1
        seqs[i] = x
        planted[i] = (gm.name, n_planted)
    return profiles, seqs, planted


def test_calibration_null_pass_rates():
    """Calibration fidelity: on FRESH null sequences the F1 gate passes
    within ~25% of its nominal 2% contract (HMMER's MSV filter
    design point, mirrored at ``pipeline.SearchPipeline(F1=0.02)``).

    This pins what the benchmark's survivor counts mean: with correct
    calibration any excess over ~2% comes from true-homology-adjacent
    pairs (planted/real domains lighting up related profiles), not
    from loose Gumbel fits.
    """
    import math

    from gecco_tpu.hmm.batch import ProfileBank, ssv_scores
    from gecco_tpu.hmm.calibrate import calibrate
    from gecco_tpu.hmm.profile import null1_score
    from gecco_tpu.hmm.synthetic import pfam_shaped_profiles

    LOG2 = math.log(2.0)
    profiles = [p for p in pfam_shaped_profiles(90, seed=2) if p.M <= 300]
    calibrate(profiles)
    bank = ProfileBank.build(profiles)
    rng = numpy.random.default_rng(424)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    seqs = [rng.choice(20, size=300, p=p_bg).astype(numpy.int32)
            for _ in range(300)]
    bits = (numpy.asarray(ssv_scores(bank, seqs), dtype=numpy.float64)
            - null1_score(300)) / LOG2
    y = LOG2 * (bits - bank.msv_mu[None, :])
    pv = numpy.where(
        y > 30, numpy.exp(-y),
        1.0 - numpy.exp(-numpy.exp(-numpy.minimum(y, 30))),
    )
    rate = float((pv <= 0.02).mean())
    assert 0.014 <= rate <= 0.026, rate


def test_multidomain_adversarial_repeats():
    """Adversarial repeat proteins: the deterministic expected-B
    envelope splitter recovers the PLANTED architecture where
    greedy/stochastic splitting plausibly diverges.

    Fixtures: (a) three tandem strong copies with normal linkers;
    (b) two copies separated by a 4-residue linker (near-touching —
    a single merged region that MUST be split); (c) a weak (45%
    mutated) copy flanked by two strong copies (the weak middle must
    neither vanish nor absorb its neighbours).  Bound asserted (and
    documented in docs/parity.md deviation #3): envelope COUNT equals
    the planted copy count, envelopes are disjoint and ordered, and
    every planted copy's midpoint falls inside exactly one envelope.
    """
    from gecco_tpu.hmm.calibrate import calibrate
    from gecco_tpu.hmm.synthetic import synthetic_profiles

    (gm,) = synthetic_profiles(1, min_length=50, max_length=50, seed=33)
    calibrate([gm], n=160, L=160, seed=6)
    rng = numpy.random.default_rng(17)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    consensus = numpy.argmax(gm.hmm.match[1:, :20], axis=1).astype(numpy.int32)

    def background(n):
        return rng.choice(20, size=n, p=p_bg).astype(numpy.int32)

    def build(linkers, divergences):
        x = [background(30)]
        mids = []
        pos = 30
        for linker, div in zip(linkers, divergences):
            copy = consensus.copy()
            mutate = rng.random(len(copy)) < div
            copy[mutate] = rng.choice(
                20, size=int(mutate.sum()), p=p_bg).astype(numpy.int32)
            x.append(copy)
            mids.append(pos + len(copy) // 2)
            x.append(background(linker))
            pos += len(copy) + linker
        x.append(background(30))
        return numpy.concatenate(x), mids

    cases = [
        # (fixture, max extra envelopes allowed beyond the planted count)
        (build([20, 20, 20], [0.1, 0.1, 0.1]), 0),  # tandem, normal linkers
        (build([4, 30], [0.1, 0.1]), 0),            # near-touching pair
        # weak (45% mutated) copy in the middle: its expected-B mass is
        # genuinely ambiguous (~1.7 begins), so the splitter may emit
        # one extra sub-envelope for it — bounded and confined below
        (build([15, 15, 30], [0.1, 0.45, 0.1]), 1),
    ]
    for (x, mids), slack in cases:
        fwd = engine.forward(gm, x)
        domains = engine.define_domains(gm, x, fwd)
        assert len(mids) <= len(domains) <= len(mids) + slack, (
            len(domains), len(mids))
        spans = sorted((d.ienv, d.jenv) for d in domains)
        for (a1, b1), (a2, b2) in zip(spans, spans[1:]):
            assert b1 < a2  # disjoint, ordered
        # every STRONG planted copy's midpoint sits in exactly one
        # envelope, and no envelope spans two planted copies
        copy_bounds = [(m - gm.M // 2, m + gm.M // 2) for m in mids]
        for mid in (mids[0], mids[-1]):
            holders = [s for s in spans if s[0] <= mid + 1 <= s[1]]
            assert len(holders) == 1, (mid, spans)
        for a, b in spans:
            covered = [m for m in mids if a <= m + 1 <= b]
            assert len(covered) <= 1, (a, b, mids)
        # the device pipeline reports the same adversarial regions
        pipe = SearchPipeline([gm], Z=1, domZ=1)
        (hit,) = pipe.search([x])
        assert [(d.ienv, d.jenv) for d in hit.domains] == [
            (d.ienv, d.jenv) for d in domains]


def test_multidomain_device_matches_host(multidomain_workload):
    """The device pipeline (filters on the XLA engines) reports what the
    float64 host path reports, on hits far above the filter gates."""
    profiles, seqs, _ = multidomain_workload
    gates = dict(Z=6, domZ=6, E=1e-3, domE=1e-3)
    device = SearchPipeline(profiles, **gates).search(seqs)
    host = SearchPipeline(profiles, use_accelerator=False, **gates).search(seqs)
    assert [(h.sequence_index, h.profile.name) for h in device] == [
        (h.sequence_index, h.profile.name) for h in host]
    n_multi = 0
    for a, b in zip(device, host):
        assert a.score == pytest.approx(b.score, abs=5e-3)
        assert len(a.domains) == len(b.domains)
        n_multi += len(a.domains) >= 2
        for da, db in zip(a.domains, b.domains):
            assert (da.ienv, da.jenv) == (db.ienv, db.jenv)
            assert (da.target_from, da.target_to) == (db.target_from, db.target_to)
            assert (da.hmm_from, da.hmm_to) == (db.hmm_from, db.hmm_to)
            # bitscore includes the null2 correction on both paths
            assert da.bitscore == pytest.approx(db.bitscore, abs=5e-2)
            assert da.i_evalue == pytest.approx(db.i_evalue, rel=0.2)
    assert n_multi >= 3  # the workload genuinely exercises splitting


def test_multidomain_envelopes_match_host(multidomain_workload):
    """Per reported pair the float64 host engine defines the same
    envelopes/alignments (region finding + expected-B splitting +
    null2 + optimal accuracy, engine.define_domains)."""
    profiles, seqs, _ = multidomain_workload
    by_name = {gm.name: gm for gm in profiles}
    hits = SearchPipeline(profiles, Z=6, domZ=6).search(seqs)
    assert hits
    for h in hits:
        gm = by_name[h.profile.name]
        expected = [
            d for d in engine.define_domains(gm, seqs[h.sequence_index])
            if d.pvalue * 6 <= 10.0
        ]
        assert len(h.domains) == len(expected)
        for da, db in zip(h.domains, expected):
            assert (da.ienv, da.jenv) == (db.ienv, db.jenv)
            assert (da.target_from, da.target_to) == (db.target_from, db.target_to)
            assert (da.hmm_from, da.hmm_to) == (db.hmm_from, db.hmm_to)
            assert da.bitscore == pytest.approx(db.bitscore, abs=5e-2)


def test_multidomain_counts_match_planted(multidomain_workload):
    """Well-separated tandem copies are resolved into that many
    envelopes for the planted profile."""
    profiles, seqs, planted = multidomain_workload
    hits = SearchPipeline(profiles, Z=6, domZ=6).search(seqs)
    by_pair = {(h.sequence_index, h.profile.name): h for h in hits}
    resolved = 0
    for i, (name, n_planted) in planted.items():
        h = by_pair.get((i, name))
        if h is not None and len(h.domains) == n_planted:
            resolved += 1
    # the planted emissions are diverged homologs; most but not
    # necessarily all pairs resolve to the exact copy count
    assert resolved >= len(planted) - 2


def test_quad_ssv_near_cap_profile_exact():
    """A profile within one node of the padded width: the best SSV
    diagonal ends at the LAST model node, at varying residue phases, and
    the kernel's last diagonal block must still reach it."""
    from gecco_tpu.hmm.ssv import ssv_scores_pallas
    from gecco_tpu.hmm.synthetic import synthetic_profiles

    (gm,) = synthetic_profiles(1, min_length=127, max_length=127, seed=3)
    assert gm.M == 127
    bank = batch.ProfileBank.build([gm])
    assert bank.Mp == 128
    rng = numpy.random.default_rng(0)
    cons = numpy.argmax(gm.hmm.match[1:, :20], axis=1)
    xs = []
    for off in range(5):
        x = rng.integers(0, 20, 200).astype(numpy.int32)
        x[off : off + len(cons)] = cons
        xs.append(x)
    scores = ssv_scores_pallas(bank, xs, pad_to=256, interpret=True)
    for s, x in enumerate(xs):
        reference = engine.ssv_score(gm, x)
        assert scores[s, 0] == pytest.approx(reference, abs=1e-4), s


def test_pipeline_empty_sequence_in_batch(profiles, sequences):
    """A zero-length sequence in the batch scores no hits instead of
    crashing the whole search (review r5: null1_score(0) raised
    math domain error)."""
    from gecco_tpu.hmm.pipeline import SearchPipeline

    xs = [x for _, x in sequences][:2]
    batch_with_empty = [xs[0], numpy.zeros(0, dtype=numpy.int64), xs[1]]
    pipeline = SearchPipeline(profiles, Z=10, domZ=10)
    hits = pipeline.search(batch_with_empty)
    assert all(h.sequence_index != 1 for h in hits)
    # the same sequences still hit at their new indices
    base = {(h.sequence_index, h.profile.name)
            for h in SearchPipeline(profiles, Z=10, domZ=10).search(xs)}
    remapped = {(0 if s == 0 else 1, n)
                for s, n in ((h.sequence_index, h.profile.name)
                             for h in hits)}
    assert remapped == {(0 if s == 0 else 1, n) for s, n in base}


def test_pipeline_single_device_list_pins_and_matches(profiles, sequences):
    """An explicit one-element device list is honored (previously it
    was silently ignored) and produces identical results."""
    import jax

    from gecco_tpu.hmm.pipeline import SearchPipeline

    xs = [x for _, x in sequences]
    pinned = SearchPipeline(profiles, Z=10, domZ=10,
                            devices=[jax.devices()[3]])
    default = SearchPipeline(profiles, Z=10, domZ=10)
    a = pinned.search(xs)
    b = default.search(xs)
    assert [(h.sequence_index, h.profile.name, round(h.score, 4))
            for h in a] == [(h.sequence_index, h.profile.name,
                             round(h.score, 4)) for h in b]
    assert len(a) > 0


def test_pipeline_stats_reset_on_empty_call(profiles, sequences):
    """An empty search() must not report the previous batch's stats."""
    from gecco_tpu.hmm.pipeline import SearchPipeline

    pipeline = SearchPipeline(profiles, Z=10, domZ=10)
    pipeline.search([x for _, x in sequences])
    assert pipeline.stage_counts
    pipeline.search([])
    assert pipeline.stage_counts == {} and pipeline.stage_cells == {}


def test_pipeline_max_filter_superset(profiles, sequences):
    """`max_filter=True` (hmmsearch --max) skips the F1/F2 gates: its
    reported hits are a superset of the default pipeline's, repeated
    searches give the same hits, and the skipped filter stage charges
    no cells (review r5)."""
    from gecco_tpu.hmm.pipeline import SearchPipeline

    xs = [x for _, x in sequences]
    default = SearchPipeline(profiles, Z=10, domZ=10)
    maxp = SearchPipeline(profiles, Z=10, domZ=10, max_filter=True)
    base = {(h.sequence_index, h.profile.name) for h in default.search(xs)}
    first = maxp.search(xs)
    got = {(h.sequence_index, h.profile.name) for h in first}
    assert base <= got and len(first) > 0
    assert maxp.stage_cells["filter"] == 0.0
    second = maxp.search(xs)
    assert {(h.sequence_index, h.profile.name) for h in second} == got

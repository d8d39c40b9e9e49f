"""Deterministic synthetic profile/sequence generators for tests & benchmarks.

The full 2,766-profile Pfam subset the reference downloads at install
time (``setup.py:344-372``) cannot be fetched in a hermetic
environment; benchmarks therefore run on synthetic banks with a
Pfam-like length distribution, which exercise exactly the same kernels.
"""

from typing import Dict, List, Tuple

import numpy

from .io import BACKGROUND_F, ProfileHMM
from .profile import SearchProfile, configure_local

__all__ = [
    "synthetic_profiles", "synthetic_proteins", "plant_domain",
    "pfam_shaped_lengths", "pfam_shaped_profiles", "synthetic_genome",
]


def synthetic_profiles(
    count: int,
    min_length: int = 40,
    max_length: int = 250,
    seed: int = 0,
) -> List[SearchProfile]:
    """Generate ``count`` random-but-plausible configured profiles."""
    rng = numpy.random.default_rng(seed)
    profiles = []
    for p in range(count):
        M = int(rng.integers(min_length, max_length + 1))
        match = rng.dirichlet(numpy.full(20, 0.3), size=M + 1)
        insert = numpy.tile(BACKGROUND_F, (M + 1, 1))
        trans = numpy.zeros((M + 1, 7))
        for k in range(M + 1):
            mm = rng.dirichlet(numpy.array([50.0, 1.0, 1.0]))
            trans[k] = [mm[0], mm[1], mm[2], 0.5, 0.5, 0.6, 0.4]
        trans[M] = [1.0, 0.0, 0.0, 0.5, 0.5, 1.0, 0.0]
        hmm = ProfileHMM(
            name=f"SYN{p:05d}", accession=f"SY{p:05d}.1", description=None,
            length=M, alphabet="amino", match=match, insert=insert, trans=trans,
            stats={
                "MSV": (-8.0 - 0.01 * (M // 10), 0.70),
                "VITERBI": (-9.0, 0.70),
                "FORWARD": (-5.0, 0.70),
            },
        )
        profiles.append(configure_local(hmm))
    return profiles


def synthetic_proteins(
    count: int,
    mean_length: int = 280,
    seed: int = 1,
) -> List["numpy.ndarray"]:
    """Generate encoded protein sequences with background composition."""
    rng = numpy.random.default_rng(seed)
    lengths = numpy.clip(
        rng.gamma(4.0, mean_length / 4.0, size=count).astype(int), 40, 4 * mean_length
    )
    p = BACKGROUND_F / BACKGROUND_F.sum()
    return [
        rng.choice(20, size=int(L), p=p).astype(numpy.int32)
        for L in lengths
    ]


def plant_domain(
    x: "numpy.ndarray",
    gm: SearchProfile,
    rng: "numpy.random.Generator",
    offset: int = 10,
    max_len: int = 100,
    divergence: float = 0.35,
) -> "numpy.ndarray":
    """Overwrite part of ``x`` with residues emitted from the profile.

    Samples a match-state path (emissions drawn from each node's match
    distribution, occasional node skips, ``divergence`` of positions
    substituted with background draws) so the sequence genuinely
    scores against ``gm`` — used to give benchmark workloads
    production-like hit rates so the domain-definition stage is
    exercised.  The divergence matters for load realism: a verbatim
    emission trace is a ~100%-identity hit, which passes the weak SSV
    filter against hundreds of unrelated profiles; real Pfam hits are
    diverged homologs (seed alignments sit at ~30-60% identity) whose
    cross-profile filter pass rate stays near the calibrated 2%.
    """
    match = gm.hmm.match[1:, :20]
    cdf = numpy.cumsum(match / match.sum(axis=1, keepdims=True), axis=1)
    u = rng.random((len(cdf), 1))
    emitted = (u > cdf).sum(axis=1).astype(numpy.int32)
    emitted = numpy.minimum(emitted, 19)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    mutate = rng.random(len(emitted)) < divergence
    emitted[mutate] = rng.choice(20, size=int(mutate.sum()), p=p_bg)
    keep = rng.random(len(emitted)) > 0.08          # ~8% deletions
    emitted = emitted[keep][:max_len]
    n = min(len(emitted), len(x) - offset)
    if n <= 0:
        return x
    out = x.copy()
    out[offset : offset + n] = emitted[:n]
    return out


def pfam_shaped_lengths(count: int, seed: int = 0) -> "numpy.ndarray":
    """Model lengths following the real Pfam-A node-count histogram.

    Pfam 35 model lengths are roughly log-normal: median ~=130 nodes,
    bulk 50-400, a thin tail reaching past 2,000 (e.g. PF12252 at 2207).
    A clipped log-normal with ``mu=log(140), sigma=0.72`` reproduces
    that shape closely enough for kernel benchmarking (bucket fill,
    padded-width mix) — unlike a uniform [40, 250] draw, which never
    exercises the wide buckets at all.  The longest draw is pinned at
    the 2,200-node ceiling, so every bank of this shape reaches the
    widest padded width a Pfam-sized bank has.
    """
    rng = numpy.random.default_rng(seed)
    lengths = rng.lognormal(mean=numpy.log(140.0), sigma=0.72, size=count)
    lengths = numpy.clip(lengths, 25, 2200).astype(int)
    lengths[numpy.argmax(lengths)] = 2200
    return lengths


def pfam_shaped_profiles(count: int, seed: int = 0) -> List[SearchProfile]:
    """``synthetic_profiles`` with a real-Pfam length histogram."""
    lengths = pfam_shaped_lengths(count, seed=seed)
    rng = numpy.random.default_rng(seed + 1)
    profiles = []
    for p, M in enumerate(lengths):
        M = int(M)
        match = rng.dirichlet(numpy.full(20, 0.3), size=M + 1)
        insert = numpy.tile(BACKGROUND_F, (M + 1, 1))
        trans = numpy.zeros((M + 1, 7))
        mm = rng.dirichlet(numpy.array([50.0, 1.0, 1.0]), size=M + 1)
        trans[:, 0:3] = mm
        trans[:, 3:7] = [0.5, 0.5, 0.6, 0.4]
        trans[M] = [1.0, 0.0, 0.0, 0.5, 0.5, 1.0, 0.0]
        hmm = ProfileHMM(
            name=f"SYN{p:05d}", accession=f"SY{p:05d}.1", description=None,
            length=M, alphabet="amino", match=match, insert=insert, trans=trans,
            stats={
                "MSV": (-8.0 - 0.01 * (M // 10), 0.70),
                "VITERBI": (-9.0, 0.70),
                "FORWARD": (-5.0, 0.70),
            },
        )
        profiles.append(configure_local(hmm))
    return profiles


_CODON_BASES = "ACGT"


def synthetic_genome(
    n_genes: int = 3000,
    mean_gene: int = 900,
    intergenic: int = 120,
    seed: int = 0,
) -> str:
    """A bacterial-genome-shaped DNA string for gene-caller benchmarks.

    Alternating coding stretches (codon-biased, started with ATG, ended
    with TAA, strand flipped at random) and short intergenic spacers —
    random uniform DNA has a stop codon every ~21 codons and therefore
    produces none of the long-ORF candidate load a real genome gives
    the scanner; this layout reproduces realistic candidate statistics
    (ORF length histogram, ~85% coding density).
    """
    rng = numpy.random.default_rng(seed)
    # codon usage chosen so the TRANSLATED proteins match the Easel
    # amino background (p7_AminoFrequencies): the average real proteome
    # sits close to that composition, and HMMER's F1=2% MSV filter
    # contract is calibrated against it — a skewed codon model (e.g.
    # GC-rich) inflates the filter pass rate ~3x and mis-shapes every
    # downstream stage's benchmark load
    from ..seq import translate
    from .io import AMINO_ALPHABET, BACKGROUND_F

    aa_freq = dict(zip(AMINO_ALPHABET, BACKGROUND_F / BACKGROUND_F.sum()))
    codons = [a + b + c for a in _CODON_BASES for b in _CODON_BASES for c in _CODON_BASES]
    amino_of = {codon: translate(codon) for codon in codons}
    codons_per_aa: Dict[str, int] = {}
    for aa in amino_of.values():
        codons_per_aa[aa] = codons_per_aa.get(aa, 0) + 1
    weights = numpy.array([
        aa_freq.get(amino_of[codon], 0.0) / codons_per_aa[amino_of[codon]]
        for codon in codons
    ])
    weights /= weights.sum()
    parts: List[str] = []
    for _ in range(n_genes):
        n_codons = max(30, int(rng.gamma(4.0, mean_gene / 4.0 / 3)))
        body = "".join(rng.choice(codons, size=n_codons, p=weights))
        gene = "ATG" + body + "TAA"
        if rng.random() < 0.5:
            complement = str.maketrans("ACGT", "TGCA")
            gene = gene.translate(complement)[::-1]
        spacer_len = max(20, int(rng.gamma(2.0, intergenic / 2.0)))
        spacer = "".join(rng.choice(list(_CODON_BASES), size=spacer_len))
        parts.append(gene)
        parts.append(spacer)
    return "".join(parts)

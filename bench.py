#!/usr/bin/env python
"""Single-chip benchmark: full-pipeline throughput (genomes/hour/chip).

Times the REAL production path of ``gecco run`` on one chip, per stage:

Numeric parity on the card is ``chip_smoke.py``'s (phases 1-2); run it
first.

1. **gene calling** — ``ScanFinder`` (host + C++ core) on a 3 Mbp
   synthetic bacterial-genome-shaped contig (~3,000 genes, ~85% coding
   density).
2. **annotate** — ``SearchPipeline.search`` over a 2,766-profile bank
   with the real Pfam-A length histogram (log-normal, median ~134
   nodes, tail to 2,200 — ``synthetic.pfam_shaped_profiles``): SSV
   filter of all pairs, Viterbi F2 gate and Forward on the survivors,
   host domain definition.  ~75% of the called proteins carry one
   planted diverged domain so the stage loads match production (~1
   reported domain per gene).
3. **decode** — windowed CRF forward-backward marginals (W=20, step 1)
   for a full-genome gene chain with max-pooling.

The bank is synthetic (the real Pfam ``.h3m`` cannot be downloaded in a
hermetic environment) — identical kernels, real shapes.  A "genome" is
normalized to 3,000 proteins.

Per-stage wall seconds, DP cells, and Gcells/s come from
``SearchPipeline.stage_seconds``/``stage_cells``; they are printed on
stderr and embedded in the JSON line under ``"stages"``.

The headline number is STEADY-STATE batch throughput: gene calling of
genome k+1 runs on the host (C++ core, GIL released) while the chip
searches genome k (``gecco_tpu.parallel.pipelined_map``), measured
over a 3-genome pipeline after warmup; the sequential single-genome
latency is reported alongside on stderr AND in the JSON
(``"sequential_seconds_per_genome"``) so downstream consumers can
compare like-for-like with pre-pipelining rounds.

A second config measures the METAGENOME shape (BASELINE.md config #3):
the same genome-equivalent of sequence split into ~tens of contigs
with lognormal lengths (2–200 kb), driving the ragged paths — per-
contig gene calling (preset gate/fallback for <100 kb contigs, thread
pool), one search over all called proteins, and the per-contig CRF
window batch.  Its results are embedded in the stdout JSON under
``"metagenome"`` (stdout stays ONE line for the driver) and printed as
a standalone JSON line on stderr.

When more than one accelerator is attached, one multi-device search
(``SearchPipeline(devices="all")``) also runs and its wall seconds are
embedded under ``"multi_device"`` (single-chip environments skip it).

Baseline: the reference (pyrodigal/pyhmmer/CRFsuite on a multicore CPU
node) runs ``gecco run`` at roughly 40 genomes/hour (≈90 s/genome); no
official number is published (``BASELINE.md``), so ``vs_baseline`` is
measured against that documented estimate.

Prints one JSON line:
``{"metric": "genomes/hour/chip", "value": N, "unit": "genomes/hour",
   "vs_baseline": R, "stages": {...}}``
"""

import json
import os
import sys
import time

import numpy

GENOME_PROTEINS = 3000
GENOME_GENES = 3230   # calls ~3,000 genes de novo (the nominal genome)
BASELINE_GENOMES_PER_HOUR = 40.0
N_PROFILES = 2766
BUDGET_S = float(os.environ.get("GECCO_BENCH_BUDGET", "1500"))
PIPELINE_GENOMES = 3  # steady-state measurement depth

# ---- host stage of the batch pipeline, run in a spawned worker
# PROCESS (gecco_tpu.parallel.pipelined_map(processes=True)): the
# search's own host-side packing holds the GIL, so a worker THREAD
# degrades the overlap to the serial sum.  Worker state is rebuilt
# once in the initializer; the worker is held to the CPU.
_WORKER = {}


def _bench_worker_init(n_profiles: int) -> None:
    from gecco_tpu.hmm.synthetic import pfam_shaped_profiles
    from gecco_tpu.orf.scan import ScanFinder

    _WORKER["profiles"] = pfam_shaped_profiles(n_profiles, seed=0)
    _WORKER["finder"] = ScanFinder()


def _bench_host_stage(genome: str):
    from gecco_tpu.hmm.io import encode_sequence
    from gecco_tpu.hmm.synthetic import plant_domain
    from gecco_tpu.seq import Seq, SeqRecord

    finder = _WORKER["finder"]
    profiles = _WORKER["profiles"]
    record = SeqRecord(id="bench", seq=Seq(genome))
    called = list(finder.find_genes([record]))
    prepared = [encode_sequence(str(g.protein.seq))[:512] for g in called]
    rng = numpy.random.default_rng(7)
    for i in range(len(prepared)):
        if i % 4 != 3:
            gm = profiles[(i * 13) % len(profiles)]
            prepared[i] = plant_domain(
                prepared[i], gm, rng, max_len=min(150, gm.M))
    return prepared


def _bench_metagenome(pipeline, profiles, trans, marginals_jax, jnp):
    """One genome-equivalent as ragged contigs through the full path.

    Contig gene counts are lognormal (median ~30 genes ≈ 30 kb, clipped
    to 2–200) until the nominal genome's genes are covered — the real
    metagenome length histogram shape.  Contigs under 100 kb take the
    preset-gate/fallback calling path; the search sees the same protein
    count with ragged per-contig chains; the CRF decodes the union of
    per-contig windows in one batch (short contigs pad to W like the
    production ``ClusterCRF.predict_probabilities``).
    """
    from gecco_tpu.hmm.io import encode_sequence
    from gecco_tpu.hmm.synthetic import plant_domain, synthetic_genome
    from gecco_tpu.orf.scan import ScanFinder
    from gecco_tpu.seq import Seq, SeqRecord

    rng = numpy.random.default_rng(12)
    gene_counts = []
    while sum(gene_counts) < GENOME_GENES:
        gene_counts.append(int(numpy.clip(
            numpy.round(rng.lognormal(numpy.log(30.0), 1.0)), 2, 200)))
    records = [
        SeqRecord(id=f"ctg{i}", seq=Seq(synthetic_genome(g, seed=100 + i)))
        for i, g in enumerate(gene_counts)
    ]
    total_bp = sum(len(r.seq) for r in records)
    finder = ScanFinder()
    genes = list(finder.find_genes(records))  # warm
    t_orf = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        genes = list(finder.find_genes(records))
        t_orf = min(t_orf, time.perf_counter() - t0)

    seqs = [encode_sequence(str(g.protein.seq))[:512] for g in genes]
    rng = numpy.random.default_rng(7)
    for i in range(len(seqs)):
        if i % 4 != 3:
            gm = profiles[(i * 13) % len(profiles)]
            seqs[i] = plant_domain(seqs[i], gm, rng, max_len=min(150, gm.M))

    pipeline.search(seqs)  # warm the ragged shapes
    t0 = time.perf_counter()
    hits = pipeline.search(seqs)
    t_search = time.perf_counter() - t0
    stages = {
        name: {
            "seconds": round(pipeline.stage_seconds.get(name, 0.0), 3),
            "gcells": round(pipeline.stage_cells.get(name, 0.0) / 1e9, 3),
            "gcells_per_s": round(
                pipeline.stage_cells.get(name, 0.0) / 1e9
                / max(pipeline.stage_seconds.get(name, 0.0), 1e-9), 1),
        }
        for name in pipeline.stage_seconds
    }

    # per-contig CRF window batch (pad short chains to W, stack all)
    W = 20
    rng = numpy.random.default_rng(0)
    per_contig = {}
    for rec in records:
        n = sum(1 for x in genes if x.source.id == rec.id)
        per_contig[rec.id] = max(n, 1)
    windows = []
    for n in per_contig.values():
        em = rng.normal(size=(max(n, W), 2)).astype(numpy.float32) * 2.0
        idx = (numpy.arange(len(em) - W + 1)[:, None]
               + numpy.arange(W)[None, :])
        windows.append(em[idx])
    stacked = numpy.concatenate(windows)
    float(jnp.sum(marginals_jax(stacked, trans)))  # compile this batch size
    t0 = time.perf_counter()
    float(jnp.sum(marginals_jax(stacked, trans)))
    t_crf = time.perf_counter() - t0

    scale = GENOME_PROTEINS / max(len(seqs), 1)
    seconds = (t_orf + t_search) * scale + t_crf
    return {
        "value": round(3600.0 / seconds, 2),
        "unit": "genomes/hour",
        "contigs": len(records),
        "total_bp": total_bp,
        "genes": len(genes),
        "hits": len(hits),
        "orf_seconds": round(t_orf, 3),
        "search_seconds": round(t_search, 3),
        "crf_seconds": round(t_crf, 3),
        "windows": int(stacked.shape[0]),
        "stages": stages,
    }


def main() -> None:
    wall0 = time.perf_counter()
    import jax
    import jax.numpy as jnp

    from gecco_tpu._meta import enable_jax_compilation_cache
    from gecco_tpu.crf.decode import marginals_jax
    from gecco_tpu.hmm.io import encode_sequence
    from gecco_tpu.hmm.pipeline import SearchPipeline
    from gecco_tpu.hmm.synthetic import (
        pfam_shaped_profiles, plant_domain, synthetic_genome)
    from gecco_tpu.orf.scan import ScanFinder
    from gecco_tpu.seq import Seq, SeqRecord

    enable_jax_compilation_cache()

    # ---- stage 1: gene calling on a genome-shaped contig (host + C++)
    genome = synthetic_genome(GENOME_GENES, seed=4)
    record = SeqRecord(id="bench", seq=Seq(genome))
    finder = ScanFinder()
    genes = list(finder.find_genes([record]))  # warm (builds the C++ core)
    t_orf = float("inf")
    for _ in range(2):  # best-of-2: host timing is noisy on shared CPUs
        t0 = time.perf_counter()
        genes = list(finder.find_genes([record]))
        t_orf = min(t_orf, time.perf_counter() - t0)

    # ---- build the annotation workload from the CALLED proteins
    profiles = pfam_shaped_profiles(N_PROFILES, seed=0)
    rng = numpy.random.default_rng(7)
    seqs = [encode_sequence(str(g.protein.seq))[:512] for g in genes]
    for i in range(len(seqs)):
        if i % 4 != 3:  # ~75% of proteins carry one real Pfam-like domain
            gm = profiles[(i * 13) % N_PROFILES]
            seqs[i] = plant_domain(seqs[i], gm, rng, max_len=min(150, gm.M))

    # hmmbuild-style E-value calibration (set-up, like HMMER's own at
    # bank build): synthetic profiles need the simulation-fitted STATS
    # or the filter pass rates (and so the stage-2/3 load) are
    # unrealistic
    from gecco_tpu.hmm.calibrate import calibrate

    calibrate(profiles)
    pipeline = SearchPipeline(profiles, Z=N_PROFILES, domZ=N_PROFILES)

    # the first search compiles every stage's shapes; results come back
    # to the host, so each timed search ends when the device is done
    hits = pipeline.search(seqs)
    t_search = float("inf")
    stages = None
    runs = 2 if time.perf_counter() - wall0 < 0.75 * BUDGET_S else 1
    for _ in range(runs):  # best-of-2: host timing is noisy
        t0 = time.perf_counter()
        hits = pipeline.search(seqs)
        elapsed = time.perf_counter() - t0
        if elapsed < t_search:
            t_search = elapsed
            stages = {
                name: {
                    "seconds": round(pipeline.stage_seconds.get(name, 0.0), 3),
                    "gcells": round(pipeline.stage_cells.get(name, 0.0) / 1e9, 3),
                    "gcells_per_s": round(
                        pipeline.stage_cells.get(name, 0.0) / 1e9
                        / max(pipeline.stage_seconds.get(name, 0.0), 1e-9), 1),
                }
                for name in pipeline.stage_seconds
            }
    n_domains = sum(len(h.domains) for h in hits)

    # ---- CRF decode of one genome-sized gene chain
    rng = numpy.random.default_rng(0)
    emissions = rng.normal(size=(GENOME_GENES, 2)).astype(numpy.float32) * 2.0
    W = 20
    index = numpy.arange(GENOME_GENES - W + 1)[:, None] + numpy.arange(W)[None, :]
    windows = emissions[index]
    trans = numpy.array([[2.67, -2.6], [-2.6, 2.57]], dtype=numpy.float32)
    float(jnp.sum(marginals_jax(windows, trans)))  # compile at full shape
    t0 = time.perf_counter()
    float(jnp.sum(marginals_jax(windows, trans)))
    t_crf = time.perf_counter() - t0

    # ---- steady-state batch throughput: gene calling of genome k+1
    # (in a worker process) overlaps the device search of genome k
    # (the production batch pattern, ``gecco_tpu.parallel.pipelined_map
    # (processes=True)``); every kernel shape is already warm from the
    # timed search above.  The worker's one-time initializer cost is
    # excluded by priming the pool with a tiny first item.
    from gecco_tpu.parallel import pipelined_map

    runner = pipelined_map(
        _bench_host_stage, pipeline.search,
        [genome] * (PIPELINE_GENOMES + 1),
        processes=True,
        initializer=_bench_worker_init, initargs=(N_PROFILES,),
    )
    next(runner)  # absorbs the worker's one-time initializer cost
    t0 = time.perf_counter()
    for out in runner:
        assert len(out) > 0
    t_pipelined = (time.perf_counter() - t0) / PIPELINE_GENOMES

    # ---- optional multi-device search (guarded: most environments
    # attach one chip; with N>1 this keeps the sharded path warm and
    # records its aggregate wall)
    multi_device = None
    if len(jax.local_devices()) > 1:
        multi = SearchPipeline(
            profiles, Z=N_PROFILES, domZ=N_PROFILES, devices="all")
        multi.search(seqs)  # compile/warm the sharded dispatch
        t0 = time.perf_counter()
        multi_hits = multi.search(seqs)
        t_multi = time.perf_counter() - t0
        multi_device = {
            "devices": multi.stage_devices,
            "seconds": round(t_multi, 3),
            "hits": len(multi_hits),
            # stage_seconds is the slowest device's wall; stage_cells
            # sums across devices, so cells/seconds here is the
            # AGGREGATE rate of all chips (see SearchPipeline docs)
            "stages": {
                name: {
                    "seconds": round(multi.stage_seconds.get(name, 0.0), 3),
                    "gcells": round(
                        multi.stage_cells.get(name, 0.0) / 1e9, 3),
                }
                for name in multi.stage_seconds
            },
        }

    # ---- metagenome config: the same genome-equivalent as ragged
    # contigs (lognormal 2-200 kb), per-contig gene calling + one
    # search + the per-contig CRF window batch, measured sequentially
    metagenome = None
    if (os.environ.get("GECCO_BENCH_METAGENOME", "1") != "0"
            and time.perf_counter() - wall0 < 0.8 * BUDGET_S):
        metagenome = _bench_metagenome(
            pipeline, profiles, trans, marginals_jax, jnp)

    # a "genome" is nominally 3,000 proteins; the caller finds ~that
    # many in the 3 Mbp contig, so the scale factor is ~1
    scale = GENOME_PROTEINS / len(seqs)
    seconds_per_genome = t_pipelined * scale + t_crf
    sequential = (t_orf + t_search) * scale + t_crf
    genomes_per_hour = 3600.0 / seconds_per_genome
    result = {
        "metric": "genomes/hour/chip",
        "value": round(genomes_per_hour, 2),
        "unit": "genomes/hour",
        "vs_baseline": round(genomes_per_hour / BASELINE_GENOMES_PER_HOUR, 2),
        "seconds_per_genome": round(seconds_per_genome, 3),
        "sequential_seconds_per_genome": round(sequential, 3),
        "stages": stages,
        "metagenome": metagenome,
        "multi_device": multi_device,
    }
    print(json.dumps(result))
    if metagenome is not None:
        print(json.dumps({"metric": "metagenome_genomes/hour/chip",
                          **metagenome}), file=sys.stderr)
    counts = pipeline.stage_counts
    print(
        f"# orf={t_orf:.2f}s ({len(genes)} genes / {len(genome)} bp) "
        f"search={t_search:.3f}s ({len(hits)} hits, {n_domains} domains, "
        f"{len(seqs)} proteins x {N_PROFILES} profiles) crf={t_crf:.3f}s "
        f"pipelined={t_pipelined:.2f}s/genome "
        f"sec/genome={seconds_per_genome:.2f} (sequential {sequential:.2f}) "
        f"device={jax.devices()[0].platform}",
        file=sys.stderr,
    )
    print(f"# survivors: {counts}", file=sys.stderr)
    if stages:
        for name, s in stages.items():
            print(f"# stage {name}: {s['seconds']}s "
                  f"{s['gcells']} Gcells -> {s['gcells_per_s']} Gcells/s",
                  file=sys.stderr)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of GECCO-TPU's main path on NVIDIA GPUs.

Run from the repository root on a machine with a GPU::

    python chip_smoke.py                # phases 0-3, one card
    python chip_smoke.py --four-cards   # phase 4 only, four cards

Phases (every one runs on the GPU; the first failure ends the run with
a non-zero exit code and no result line):

0. **Device.**  JAX's devices, the card's name and power limit (from
   ``nvidia-smi`` in a child process).  Fails unless JAX's platform is
   ``gpu``.
1. **Kernel parity at real widths.**  A Pfam-shaped bank of 2,766
   profiles (widest 2,200 nodes) against proteins up to 2,048 residues:
   the SSV engine ``run`` uses, and the XLA Viterbi and Forward
   engines, against the float64 host engine on sampled pairs.
2. **Pipeline parity.**  ``SearchPipeline`` on the device against its
   float64 host path on a 48-profile sub-bank and 32 planted proteins:
   identical hits and domain coordinates, scores within tolerance.
3. **``gecco-tpu run`` at real size**, in process, on a synthetic
   genome with a planted multi-gene cluster, against the whole bank
   written as ``.h3m`` and named after the embedded model's domains.
4. **``--four-cards``**: ``annotate --devices 4`` and ``--devices 1``
   on one genome write byte-identical feature tables.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import csv
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy

SEED = 0
N_PROFILES = 2766      # GECCO's Pfam subset (gecco_tpu/data/Pfam.ini)
LONGEST = 2048         # residues of the longest parity protein
SCORE_TOL = 1e-2       # nats: f32 DP over ~2,000 residues, ~1e-3 expected
N_GENES = 300          # background genes of the phase 3 genome
N_PLANTED = 7          # genes of the planted cluster
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "gecco_tpu", "data")


def log(*parts) -> None:
    print(*parts, flush=True)


class PhaseError(RuntimeError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise PhaseError(message)


# -- phase 0 -----------------------------------------------------------------


def phase_device() -> dict:
    import jax

    devices = jax.devices()
    first = devices[0]
    log("phase 0: jax", jax.__version__, "devices", devices)
    log(f"phase 0: platform={first.platform} kind={first.device_kind} "
        f"count={len(devices)}")
    check(first.platform == "gpu", f"JAX runs on {first.platform!r}, not a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log("phase 0: card", card)
    return {"platform": first.platform, "kind": first.device_kind,
            "count": len(devices), "card": card}


# -- inputs ------------------------------------------------------------------


def pfam_bank(count: int = N_PROFILES, seed: int = SEED):
    """Calibrated Pfam-shaped profiles named after the embedded model's
    domains (``PFxxxxx.1``, so ``data/Pfam.ini``'s relabel rule applies);
    returns them with the calibration's seconds."""
    from gecco_tpu.hmm.calibrate import calibrate
    from gecco_tpu.hmm.synthetic import pfam_shaped_profiles

    profiles = pfam_shaped_profiles(count, seed=seed)
    with open(os.path.join(DATA, "domains.tsv")) as handle:
        names = [line.strip() for line in handle if line.strip()][:count]
    for gm, name in zip(profiles, names):
        gm.hmm.name = name
        gm.hmm.accession = name + ".1"
    start = time.perf_counter()
    calibrate(profiles)
    return profiles, time.perf_counter() - start


def planted_proteins(profiles, count: int, seed: int, longest: int = 0):
    """Background proteins, each carrying one profile's consensus (up to
    300 nodes) with 30% of its residues redrawn from the background: a
    hit far above every filter gate, so the device path (gated) and the
    host path (ungated) must report it alike.  With ``longest``, the
    first protein is that long."""
    from gecco_tpu.hmm.io import BACKGROUND_F
    from gecco_tpu.hmm.synthetic import synthetic_proteins

    rng = numpy.random.default_rng(seed)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    xs = synthetic_proteins(count, mean_length=300, seed=seed)
    if longest:
        xs[0] = synthetic_proteins(1, mean_length=longest * 4, seed=seed)[0][:longest]
        check(len(xs[0]) == longest, "long protein too short")
    planted = []
    for i, x in enumerate(xs):
        p = int(rng.integers(len(profiles)))
        copy = numpy.argmax(profiles[p].hmm.match[1:, :20], axis=1)
        copy = copy[: min(300, len(x) - 20)].astype(numpy.int32)
        redraw = rng.random(len(copy)) < 0.3
        copy[redraw] = rng.choice(20, size=int(redraw.sum()), p=p_bg)
        xs[i] = x.copy()
        xs[i][10:10 + len(copy)] = copy
        planted.append(p)
    return xs, planted


# -- phase 1 -----------------------------------------------------------------


def phase_kernels(profiles, seed: int = SEED, longest: int = LONGEST) -> None:
    from gecco_tpu.hmm import batch, engine

    bank = batch.ProfileBank.build(profiles)
    widest = int(numpy.argmax(bank.lengths))
    xs, _ = planted_proteins(profiles, 64, seed + 10, longest=longest)
    start = time.perf_counter()
    ssv = batch.ssv_scores(bank, xs)
    log(f"phase 1: ssv_scores [{len(xs)} x {bank.P}] Mp={bank.Mp} "
        f"first call (compile included) {time.perf_counter() - start:.3f}s")
    rng = numpy.random.default_rng(seed)
    pairs = [(0, widest), (1, widest), (0, int(rng.integers(bank.P)))]
    pairs += [(int(rng.integers(len(xs))), int(rng.integers(bank.P)))
              for _ in range(29)]
    worst = max(abs(float(ssv[s, p]) - engine.ssv_score(profiles[p], xs[s]))
                for s, p in pairs)
    log(f"phase 1: ssv {len(pairs)} pairs (widest M={bank.lengths[widest]}, "
        f"L up to {len(xs[0])}): max |diff| = {worst:.3e} nats "
        f"(tolerance {SCORE_TOL})")
    check(worst <= SCORE_TOL, "SSV engine disagrees with engine.ssv_score")

    sub_idx = [widest] + [int(p) for p in rng.choice(bank.P, 5, replace=False)]
    sub = bank.select(sub_idx)
    seqs = [xs[0], xs[2]]
    vit = batch.viterbi_scores(sub, seqs)
    fwd = batch.forward_scores(sub, seqs)
    worst_v = worst_f = 0.0
    for s, x in enumerate(seqs):
        for c, p in enumerate(sub_idx):
            worst_v = max(worst_v, abs(float(vit[s, c])
                                       - engine.viterbi_score(profiles[p], x)))
            worst_f = max(worst_f, abs(float(fwd[s, c])
                                       - engine.forward(profiles[p], x).score))
    log(f"phase 1: viterbi {len(seqs) * len(sub_idx)} pairs (Mp={sub.Mp}): "
        f"max |diff| = {worst_v:.3e} nats (tolerance {SCORE_TOL})")
    log(f"phase 1: forward {len(seqs) * len(sub_idx)} pairs (Mp={sub.Mp}): "
        f"max |diff| = {worst_f:.3e} nats (tolerance {SCORE_TOL})")
    check(worst_v <= SCORE_TOL, "XLA Viterbi disagrees with engine.viterbi_score")
    check(worst_f <= SCORE_TOL, "XLA Forward disagrees with engine.forward")


# -- phase 2 -----------------------------------------------------------------


def phase_pipeline(profiles, n_profiles: int = 48, n_proteins: int = 32,
                   seed: int = SEED) -> None:
    from gecco_tpu.hmm.pipeline import SearchPipeline

    rng = numpy.random.default_rng(seed + 20)
    widest = max(range(len(profiles)), key=lambda p: profiles[p].M)
    others = [int(p) for p in rng.choice(len(profiles), n_profiles, replace=False)
              if p != widest][: n_profiles - 1]
    subset = [profiles[p] for p in [widest] + others]
    xs, _ = planted_proteins(subset, n_proteins, seed + 30)
    # strict reporting thresholds: the host path skips the F1/F2 gates
    # (like ``hmmsearch --max``), so only hits far above them compare
    gates = dict(Z=n_proteins, domZ=n_proteins, E=1e-3, domE=1e-3)
    start = time.perf_counter()
    device = SearchPipeline(subset, **gates).search(xs)
    t_device = time.perf_counter() - start
    start = time.perf_counter()
    host = SearchPipeline(subset, use_accelerator=False, **gates).search(xs)
    t_host = time.perf_counter() - start

    def key(hits):
        return [(h.sequence_index, h.profile.name) for h in hits]

    def coords(hit):
        return [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from,
                 d.hmm_to) for d in hit.domains]

    check(key(device) == key(host),
          f"hit sets differ: device {key(device)} host {key(host)}")
    check(all(coords(a) == coords(b) for a, b in zip(device, host)),
          "domain coordinates differ")
    worst = max([abs(a.score - b.score) for a, b in zip(device, host)]
                + [abs(da.bitscore - db.bitscore)
                   for a, b in zip(device, host)
                   for da, db in zip(a.domains, b.domains)] + [0.0])
    log(f"phase 2: {len(subset)} profiles x {len(xs)} proteins: "
        f"{len(device)} hits, {sum(len(h.domains) for h in device)} domains "
        f"identical; max |score diff| = {worst:.3e} bits "
        f"(tolerance {SCORE_TOL}); device {t_device:.3f}s host {t_host:.3f}s")
    check(len(device) >= n_proteins // 2, "too few planted hits found")
    check(worst <= SCORE_TOL, "scores differ")


# -- phase 3 -----------------------------------------------------------------


def _planted_genome(profiles, accessions, n_genes: int, seed: int):
    """A synthetic genome with one planted gene per accession in the
    middle: 250 background residues around the consensus of the
    profile's first 100 nodes.  Returns the DNA and
    ``[(start, end, accession)]`` of the planted genes (1-based)."""
    from gecco_tpu.hmm.io import AMINO_ALPHABET
    from gecco_tpu.hmm.synthetic import synthetic_genome, synthetic_proteins
    from gecco_tpu.seq import translate

    rng = numpy.random.default_rng(seed)
    by_acc = {gm.accession.split(".")[0]: gm for gm in profiles}
    codons = {}
    for a in "ACGT":
        for b in "ACGT":
            for c in "ACGT":
                codons.setdefault(translate(a + b + c), []).append(a + b + c)
    left = synthetic_genome(n_genes // 2, seed=seed)
    right = synthetic_genome(n_genes - n_genes // 2, seed=seed + 1)
    parts, planted, pos = [left], [], len(left)
    for k, acc in enumerate(accessions):
        gm = by_acc[acc]
        (x,) = synthetic_proteins(1, mean_length=1000, seed=seed + k)
        x = numpy.resize(x, 350)
        x[80:180] = numpy.argmax(gm.hmm.match[1:101, :20], axis=1)
        dna = "ATG" + "".join(
            codons[AMINO_ALPHABET[i]][int(rng.integers(len(codons[AMINO_ALPHABET[i]])))]
            for i in x) + "TAA"
        spacer = "".join("ACGT"[int(i)] for i in rng.integers(0, 4, 80))
        parts += [spacer, dna]
        pos += len(spacer)
        planted.append((pos + 1, pos + len(dna), acc))
        pos += len(dna)
    parts.append(right)
    return "".join(parts), planted


def _cluster_accessions(profiles, count: int):
    """The accessions the embedded CRF weights most towards clusters,
    among profiles of 100-300 nodes: a planted 100-node consensus clears
    ``run``'s default domain p-value filter (1e-9) by far."""
    model = numpy.load(os.path.join(DATA, "crf_model.npz"), allow_pickle=True)
    weight = dict(zip(model["attr_names"],
                      model["state"][:, 1] - model["state"][:, 0]))
    names = {gm.accession.split(".")[0] for gm in profiles
             if 100 <= gm.M <= 300}
    ranked = sorted((w, a) for a, w in weight.items() if a in names)
    return [a for _w, a in ranked[-count:]]


def _write_bank(profiles, directory: str):
    from gecco_tpu.hmm import HMM
    from gecco_tpu.hmm.h3m import write_h3m

    path = os.path.join(directory, "Pfam.h3m")
    write_h3m(path, [gm.hmm for gm in profiles])
    hmm = HMM(id="Pfam", version="synthetic", url="", path=path,
              size=len(profiles), relabel_with=r"s/(PF\d+).\d+/\1/")
    return lambda: iter([hmm])


@contextlib.contextmanager
def _compile_seconds():
    """Sum of XLA backend compile times inside the block."""
    import jax

    total = [0.0]

    def listener(event, duration, **_kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            total[0] += duration

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield total
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)


def phase_run(profiles, card: str, n_genes: int = N_GENES,
              seed: int = SEED) -> None:
    import jax

    from gecco_tpu.cli import main
    from gecco_tpu.profiling import TIMER

    accessions = _cluster_accessions(profiles, N_PLANTED)
    genome, planted = _planted_genome(profiles, accessions, n_genes, seed)
    with tempfile.TemporaryDirectory() as tmp:
        default_hmms = _write_bank(profiles, tmp)
        fasta = os.path.join(tmp, "genome.fna")
        with open(fasta, "w") as handle:
            handle.write(">genome\n")
            for k in range(0, len(genome), 70):
                handle.write(genome[k:k + 70] + "\n")
        out = os.path.join(tmp, "out")
        stream = io.StringIO()
        start = time.perf_counter()
        with _compile_seconds() as compiled:
            code = main(["run", "-g", fasta, "-o", out, "--force-tsv", "-vv"],
                        stream, default_hmms=default_hmms)
        wall = time.perf_counter() - start
        check(code == 0, f"run exited {code}: {stream.getvalue()[-3000:]}")
        tables = {kind: os.path.join(out, f"genome.{kind}.tsv")
                  for kind in ("genes", "features", "clusters")}
        for kind, path in tables.items():
            check(os.path.exists(path), f"no {kind} table")
        with open(tables["genes"]) as handle:
            genes = list(csv.DictReader(handle, delimiter="\t"))
        with open(tables["features"]) as handle:
            features = list(csv.DictReader(handle, delimiter="\t"))
        with open(tables["clusters"]) as handle:
            clusters = list(csv.DictReader(handle, delimiter="\t"))
    def covers(row, start_nt, end_nt):
        overlap = min(int(row["end"]), end_nt) - max(int(row["start"]), start_nt)
        return overlap > (end_nt - start_nt) // 2

    # a planted gene the gene caller found must carry its domain
    called = [(s, e, acc) for s, e, acc in planted
              if any(covers(row, s, e) for row in genes)]
    found = sum(any(covers(row, s, e) and row["domain"] == acc
                    for row in features) for s, e, acc in called)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"phase 3: run on {len(genome)} nt, {len(genes)} genes, "
        f"{len(profiles)} profiles: exit 0, {len(features)} domain rows, "
        f"{len(clusters)} clusters; planted genes called {len(called)}/"
        f"{len(planted)}, of those with their domain {found}")
    log(f"phase 3 [{card}]: wall {wall:.3f}s, XLA compile {compiled[0]:.3f}s "
        f"(set-up), peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    for name, (calls, total) in TIMER.summary().items():
        log(f"phase 3 [{card}]: timing {name}: {total:.3f}s ({calls} calls)")
    check(2 * len(called) >= len(planted), "the gene caller lost the planted genes")
    check(found == len(called), "planted genes lost their domains")


# -- phase 4 -----------------------------------------------------------------


def phase_four_cards(profiles, n_genes: int = N_GENES, seed: int = SEED) -> None:
    from gecco_tpu.cli import main

    accessions = _cluster_accessions(profiles, N_PLANTED)
    genome, _ = _planted_genome(profiles, accessions, n_genes, seed + 40)
    with tempfile.TemporaryDirectory() as tmp:
        default_hmms = _write_bank(profiles, tmp)
        fasta = os.path.join(tmp, "genome.fna")
        with open(fasta, "w") as handle:
            handle.write(">genome\n" + genome + "\n")
        outputs = {}
        for devices in ("1", "4"):
            out = os.path.join(tmp, f"out{devices}")
            stream = io.StringIO()
            start = time.perf_counter()
            code = main(["annotate", "-g", fasta, "-o", out,
                         "--devices", devices], stream,
                        default_hmms=default_hmms)
            check(code == 0, f"annotate --devices {devices} exited {code}: "
                  f"{stream.getvalue()[-3000:]}")
            with open(os.path.join(out, "genome.features.tsv"), "rb") as handle:
                outputs[devices] = handle.read()
            log(f"phase 4: annotate --devices {devices}: "
                f"{time.perf_counter() - start:.3f}s, "
                f"{len(outputs[devices].splitlines()) - 1} domain rows")
    check(outputs["1"] == outputs["4"], "features.tsv differs across devices")
    check(len(outputs["1"].splitlines()) > 1, "no domains annotated")
    log("phase 4: features.tsv byte-identical for --devices 1 and 4")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only phase 4, on four cards")
    args = parser.parse_args(argv)
    try:
        device = phase_device()
        if args.four_cards:
            check(device["count"] >= 4, "--four-cards needs four cards")
        profiles, seconds = pfam_bank()
        log(f"set-up: {len(profiles)} profiles calibrated in {seconds:.3f}s")
        if args.four_cards:
            phase_four_cards(profiles)
        else:
            phase_kernels(profiles)
            phase_pipeline(profiles)
            phase_run(profiles, device["card"])
    except Exception as err:  # every phase failure ends the run
        traceback.print_exc()
        print(f"FAILED: {type(err).__name__}: {err}", file=sys.stderr,
              flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Benchmark: GSNAP/GMAP throughput on one chip, measured END-TO-END.

Workloads on a chr21-scale genome (46.7 Mbp, tools/bench_data.py):

* DNA (headline): 100 bp reads, 1% substitutions — align_records through
  final SAM text (ladder + native emission), >= 1 s of wall; the device
  cascade is also timed alone as a secondary number.
* RNA: 40% spliced reads (1-2 GT..AG junctions) — end-to-end, with
  junction-level precision/recall/F1 against the generator's truth.
* PE: 20k FR pairs — end-to-end through the paired driver, with the
  concordance rate.
* GMAP: 256 multi-exon cDNAs through the bulk cDNA aligner.

Prints ONE JSON line, naming the device it ran on. vs_baseline ratios compare against a
32-core-EQUIVALENT of the reference: per-core AVX2 gsnap marginal
throughput (tools/measure_baseline.py, hand-built, steady-state slope)
x 32 assuming perfect core scaling — the deployment baseline BASELINE.md
demands. Timing on this backend is only trustworthy when values are
actually materialized; every timed region here ends in host bytes.
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np

BASELINE_CORES = 32


def _load_baseline():
    f = pathlib.Path(__file__).parent / "BASELINE_MEASURED.json"
    if not f.exists():
        return {}, "unmeasured"
    d = json.loads(f.read_text())
    out = {}
    for k, keys in (
            ("dna", ("gsnap_avx2_dna_marginal_rps",
                     "gsnap_avx2_reads_per_sec", "gsnap_dna_marginal_rps",
                     "gsnap_reads_per_sec")),
            ("rna", ("gsnap_avx2_rna_marginal_rps",
                     "gsnap_avx2_rna_reads_per_sec",
                     "gsnap_rna_marginal_rps", "gsnap_rna_reads_per_sec")),
            ("pe", ("gsnap_avx2_pe_marginal_rps",
                    "gsnap_avx2_pe_reads_per_sec",
                    "gsnap_pe_reads_per_sec")),
            ("gmap", ("gmap_queries_per_sec",))):
        v = next((d[key] for key in keys if d.get(key)), None)
        if v:
            out[k] = v * (BASELINE_CORES if k != "gmap" else 1)
    note = ("avx2 marginal 1-core x 32"
            if d.get("gsnap_avx2_dna_marginal_rps") else "nosimd x 32")
    return out, note


def _vs(value, base):
    return round(value / base, 2) if base else None


def main():
    import jax
    import jax.numpy as jnp

    from tools import bench_data
    from tpumap.gsnap.driver import align_records
    from tpumap.gsnap.engine import (AlignConfig,
                                     align_batch_cascaded_packed)
    from tpumap.gsnap.paired import align_paired_records
    from tpumap.ops import pack
    from tpumap.index import GenomeDB, build_db
    from tpumap.index.device import DeviceIndex
    from tpumap.io.fasta import read_fasta
    from tpumap.utils import dna

    base, base_note = _load_baseline()
    gfa, rfa = bench_data.ensure_files()
    dbdir = bench_data.ROOT / "db_k14"
    if (dbdir / "meta.json").exists():
        db = GenomeDB.load(str(dbdir))
    else:
        db = build_db(gfa, name="bench", k=14, interval=3)
        db.save(str(dbdir))
    index = DeviceIndex.from_host(db)
    config = AlignConfig(top_k=4, max_occ=4)
    B = 32768
    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "baseline": base_note}

    # ---- DNA end-to-end (headline) -----------------------------------
    # The timed region is steady state: the warm call compiles/loads every
    # program the run will use (the driver pads tail batches to the same
    # (B, L) shape, so ONE shape covers the whole run), and its wall time
    # is reported separately as warmup_s — cold start is a real cost but a
    # different number from throughput (VERDICT r3 weak #3).
    # Timed path = the production streaming path (align_records sink=...):
    # final SAM text bytes land in a buffer; accuracy is graded from the
    # same bytes afterwards, untimed.
    import io
    reads = list(read_fasta(rfa))
    t0 = time.perf_counter()
    align_records(db, index, reads[:B], config, batch_size=B,
                  sink=io.BytesIO().write)                        # warm
    out["warmup_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    stats = {}
    align_records(db, index, reads, config, batch_size=B,
                  sink=buf.write, stats=stats)
    dna_dt = time.perf_counter() - t0
    dna_rps = len(reads) / dna_dt
    out.update({
        "metric": "reads_per_sec",
        "value": round(dna_rps, 1),
        "unit": "reads/s/chip",
        "vs_baseline": _vs(dna_rps, base.get("dna")),
        "wall_s": round(dna_dt, 3),
        "sam_mb": round(buf.tell() / 1e6, 1),
        "aligned_frac": round(1 - stats.get("unmapped", 0) / len(reads),
                              4),
    })
    del buf

    # ---- DNA device cascade alone (secondary) ------------------------
    N, L = len(reads), 112
    codes = np.zeros((N, L), dtype=np.uint8)
    lengths = np.full(N, bench_data.READ_LEN, dtype=np.int32)
    for i, r in enumerate(reads):
        c, _ = dna.encode(r.sequence)
        codes[i, :len(c)] = c
    packed = pack.pack_reads_host(codes)
    stub = jnp.zeros((1, 1), dtype=jnp.uint32)
    lend = jnp.asarray(lengths[:B])

    def cascade(i):
        sl = slice(i * B, (i + 1) * B)
        pb = {"packed": jnp.asarray(packed[sl]), "pnmask": stub,
              "lengths": lend}
        return align_batch_cascaded_packed(index, pb, config, L)

    r = cascade(0)
    _ = np.asarray(r["nmismatch"])          # force real execution
    t0 = time.perf_counter()
    total = 0
    nb = N // B
    mapped = 0
    while time.perf_counter() - t0 < 1.0:   # >= 1 s of wall (VERDICT r2)
        for i in range(nb):
            r = cascade(i)
            mapped += int(np.asarray(r["mapped"]).sum())
        total += nb * B
    casc_dt = time.perf_counter() - t0
    out["dna_cascade_reads_per_sec"] = round(total / casc_dt, 1)
    out["dna_cascade_vs_baseline"] = _vs(total / casc_dt, base.get("dna"))

    # ---- RNA end-to-end + junction truth accuracy --------------------
    # RNA is device-bound (chain/salvage stages), so a 16k batch loses
    # almost nothing to RPC amortization while keeping the compaction
    # shapes half the size of the 32k DNA batch
    RB = 16384
    _, rna_rfa = bench_data.ensure_rna_files()
    rna_reads = list(read_fasta(rna_rfa))
    t0 = time.perf_counter()
    align_records(db, index, rna_reads[:RB], config, novelsplicing=True,
                  batch_size=RB, sink=io.BytesIO().write)        # warm
    out["rna_warmup_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    rbuf = io.BytesIO()
    align_records(db, index, rna_reads, config, novelsplicing=True,
                  batch_size=RB, sink=rbuf.write)
    rna_dt = time.perf_counter() - t0
    g = bench_data.grade_rna(rbuf.getvalue().decode().splitlines())
    rna_rps = len(rna_reads) / rna_dt
    out.update({
        "rna_reads_per_sec": round(rna_rps, 1),
        "rna_vs_baseline": _vs(rna_rps, base.get("rna")),
        **{f"rna_{k}": round(v, 4) for k, v in g.items()},
    })
    del rbuf

    # ---- paired-end --------------------------------------------------
    f1, f2 = bench_data.ensure_pe_files()
    r1 = list(read_fasta(f1))
    r2 = list(read_fasta(f2))
    pairs = list(zip(r1, r2))
    PB = 8192
    t0 = time.perf_counter()
    align_paired_records(db, index, pairs[:PB], config, batch_size=PB,
                         pairmax=1000, sink=io.BytesIO().write)  # warm
    out["pe_warmup_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    pbuf = io.BytesIO()
    align_paired_records(db, index, pairs, config, batch_size=PB,
                         pairmax=1000, sink=pbuf.write)
    pe_dt = time.perf_counter() - t0
    pe_rps = 2 * len(pairs) / pe_dt
    conc = bench_data.grade_pe(
        pbuf.getvalue().decode().splitlines())["concordant_frac"]
    out.update({
        "pe_reads_per_sec": round(pe_rps, 1),
        "pe_vs_baseline": _vs(pe_rps, base.get("pe")),
        "pe_concordant_frac": round(conc, 4),
    })
    del pbuf

    # ---- GMAP cDNA ----------------------------------------------------
    from tools.bench_gmap import make_queries
    from tpumap.cli.gmap_cli import align_queries_bulk
    queries = make_queries(db)
    enc = [dna.encode(q) for q in queries]
    align_queries_bulk(db, index, enc)                       # warm
    t0 = time.perf_counter()
    res = align_queries_bulk(db, index, enc)
    gmap_dt = time.perf_counter() - t0
    out["gmap_queries_per_sec"] = round(len(queries) / gmap_dt, 1)
    out["gmap_vs_baseline"] = _vs(len(queries) / gmap_dt,
                                  base.get("gmap"))
    # reference gmap is multithreaded (src/gmap.c:4867 worker pool);
    # grade against the same 32-core equivalent as the gsnap rows
    out["gmap_vs_baseline32"] = _vs(
        len(queries) / gmap_dt,
        base["gmap"] * BASELINE_CORES if base.get("gmap") else None)
    out["gmap_found_frac"] = round(sum(1 for x in res if x)
                                   / len(queries), 4)

    # ---- DP cells/sec/chip (BASELINE.json second headline) -----------
    from tpumap.ops import dp as dp_ops
    DB, DLQ, DBAND = 8192, 112, 16
    rng = np.random.default_rng(7)
    qc = jnp.asarray(rng.integers(0, 4, (DB, DLQ)).astype(np.uint8))
    gc = jnp.asarray(rng.integers(0, 4, (DB, DLQ + 2 * DBAND))
                     .astype(np.uint8))
    ql = jnp.full(DB, DLQ, jnp.int32)
    gl = jnp.full(DB, DLQ + 2 * DBAND, jnp.int32)
    r = dp_ops.banded_align(qc, ql, gc, gl, DBAND)
    _ = np.asarray(r["score"][:4])
    NREP = 10
    t0 = time.perf_counter()
    for _i in range(NREP):
        r = dp_ops.banded_align(qc, ql, gc, gl, DBAND)
    _ = np.asarray(r["score"][:4])
    dp_dt = time.perf_counter() - t0
    out["dp_cells_per_sec"] = round(
        NREP * DB * DLQ * (2 * DBAND + 1) / dp_dt, 0)

    print(json.dumps(out))


if __name__ == "__main__":
    main()

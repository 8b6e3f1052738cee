#!/usr/bin/env python3
"""GMAP (cDNA spliced alignment) throughput: tpumap vs reference gmap.

Workload: multi-exon cDNAs synthesized from the bench genome (2-6 exons,
100-400 bp each, introns 200-5000 bp). Prints one JSON line per engine.
The reference gmap must be hand-built in /tmp/refbin
(tools/build_reference.py); it runs single-threaded (1-core host).
"""
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

REFBIN = pathlib.Path("/tmp/refbin")


def query_plan(genome_length: int, n: int = 256, seed: int = 7):
    """[(exon_start, exon_len), ...] of each synthetic cDNA: 2-5 exons of
    100-399 bp, introns of 200-4999 bp."""
    rng = np.random.default_rng(seed)
    plan = []
    for _ in range(n):
        ne = int(rng.integers(2, 6))
        pos = int(rng.integers(0, genome_length - 100000))
        exons = []
        for _ in range(ne):
            el = int(rng.integers(100, 400))
            exons.append((pos, el))
            pos += el + int(rng.integers(200, 5000))
        plan.append(exons)
    return plan


def make_queries(db, n=256, seed=7):
    g = db.get_seq(0, db.genome_length)
    return ["".join(g[a:a + ln] for a, ln in exons)
            for exons in query_plan(db.genome_length, n, seed)]


def main():
    from tools import bench_data
    from tpumap.cli.gmap_cli import align_queries_bulk
    from tpumap.index import GenomeDB
    from tpumap.index.device import DeviceIndex
    from tpumap.utils import dna

    gfa, _rfa = bench_data.ensure_files()
    db = GenomeDB.load(str(bench_data.ROOT / "db_k14"))
    index = DeviceIndex.from_host(db)
    queries = make_queries(db)
    enc = [dna.encode(q) for q in queries]

    align_queries_bulk(db, index, enc)        # warm/compile
    t0 = time.perf_counter()
    res = align_queries_bulk(db, index, enc)
    dt = time.perf_counter() - t0
    nfound = sum(1 for r in res if r)
    print(json.dumps({"engine": "tpumap", "queries_per_sec":
                      round(len(queries) / dt, 2),
                      "found": nfound, "wall_s": round(dt, 3)}))

    gmap = REFBIN / "gmap"
    if gmap.exists():
        import tempfile
        d = pathlib.Path(tempfile.mkdtemp())
        qfa = d / "q.fa"
        qfa.write_text("".join(f">q{i}\n{s}\n"
                               for i, s in enumerate(queries)))
        # build a reference db once
        refdb = d / "refdb"
        subprocess.run([str(REFBIN / "gmap_build"), "-B", str(REFBIN),
                        "-D", str(refdb), "-d", "bench", "-k", "14",
                        str(gfa)], check=True, capture_output=True)
        t0 = time.perf_counter()
        out = subprocess.run([str(gmap), "-D", str(refdb), "-d", "bench",
                              "-t", "1", "-f", "psl", str(qfa)],
                             capture_output=True, text=True)
        dt = time.perf_counter() - t0
        nref = len([l for l in out.stdout.splitlines() if l.strip()])
        print(json.dumps({"engine": "reference gmap (1 core, nosimd)",
                          "queries_per_sec": round(len(queries) / dt, 2),
                          "paths": nref, "wall_s": round(dt, 3)}))


if __name__ == "__main__":
    main()

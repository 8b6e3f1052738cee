#!/usr/bin/env python3
"""Device-memory residency at scale: build a 500 Mbp genome, place its
k=15 index (dense 4^15 offsets + positions + 2-bit genome, ~5.2 GB of
device arrays) on one device, and measure DNA end-to-end throughput at
that scale vs the 46.7 Mbp bench genome.

The reference serves hg38-scale indexes from mmap (src/gsnap.c:354-360
sizing: offsets ~0.5 GB compressed + positions ~3.5 GB + genome ~1 GB);
tpumap keeps the whole index in device memory; this drives multi-GB
device tables and 4^15-row offset gathers.

Prints one JSON line.  The genome and db are cached under
tools/bench_data.ROOT (the first build is long and host-side; later
runs load and upload only).
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

GLEN = 500_000_000
K = 15
N_READS = 50_000
READ_LEN = 100
SUB_RATE = 0.01


def ensure_db():
    from tools import bench_data
    from tpumap.index import GenomeDB
    from tpumap.index.build import build_db_from_seqs

    dbdir = bench_data.ROOT / f"db_large_k{K}"
    if (dbdir / "meta.json").exists():
        return GenomeDB.load(str(dbdir))
    print(f"building {GLEN/1e6:.0f} Mbp genome + k={K} index "
          f"(one-time)...", file=sys.stderr)
    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, GLEN, dtype=np.int8)
    seq_bases = np.array(list("ACGT"), dtype="U1")
    t0 = time.time()

    def chunks():
        # one chromosome; stream the string in pieces to bound memory
        CH = 1 << 24
        parts = []
        for i in range(0, GLEN, CH):
            parts.append("".join(seq_bases[codes[i:i + CH]]))
        yield "chrL", "".join(parts)

    db = build_db_from_seqs(chunks(), name="large", k=K, interval=3)
    db.save(str(dbdir))
    print(f"built in {time.time()-t0:.0f}s", file=sys.stderr)
    return db


def make_reads(db, n=N_READS):
    rng = np.random.default_rng(78)
    gp = db.genome_packed
    starts = rng.integers(0, GLEN - READ_LEN, n)
    reads = []
    from tpumap.io.fasta import Record
    bases = "ACGT"
    for i, p in enumerate(starts):
        p = int(p)
        cs = [(int(gp[(p + j) >> 4]) >> (2 * ((p + j) & 15))) & 3
              for j in range(READ_LEN)]
        nsub = rng.binomial(READ_LEN, SUB_RATE)
        for j in rng.integers(0, READ_LEN, nsub):
            cs[int(j)] = int(rng.integers(0, 4))
        reads.append(Record(f"L{i}", "", "".join(bases[c] for c in cs)))
    return reads


def main():
    import io

    from tpumap.gsnap.driver import align_records
    from tpumap.gsnap.engine import AlignConfig
    from tpumap.index.device import DeviceIndex

    db = ensure_db()
    hbm_bytes = (db.genome_packed.nbytes + db.genome_nmask.nbytes
                 + db.offsets.nbytes + db.positions.nbytes)
    print(f"index arrays: {hbm_bytes/1e9:.2f} GB "
          f"(offsets {db.offsets.nbytes/1e9:.2f}, positions "
          f"{db.positions.nbytes/1e9:.2f}, genome "
          f"{db.genome_packed.nbytes/1e9:.2f})", file=sys.stderr)
    t0 = time.time()
    index = DeviceIndex.from_host(db)
    import jax
    jax.block_until_ready(index.offsets)
    upload_s = time.time() - t0
    print(f"upload: {upload_s:.1f}s", file=sys.stderr)
    reads = make_reads(db)
    config = AlignConfig(top_k=4, max_occ=4)
    B = 32768
    t0 = time.time()
    align_records(db, index, reads[:B], config, batch_size=B,
                  sink=io.BytesIO().write)
    warm = time.time() - t0
    t0 = time.time()
    buf = io.BytesIO()
    stats = {}
    align_records(db, index, reads, config, batch_size=B,
                  sink=buf.write, stats=stats)
    dt = time.time() - t0
    out = {
        "genome_bp": GLEN, "k": K,
        "index_hbm_gb": round(hbm_bytes / 1e9, 2),
        "hbm_upload_s": round(upload_s, 1),
        "warmup_s": round(warm, 1),
        "large_reads_per_sec": round(len(reads) / dt, 1),
        "aligned_frac": round(1 - stats.get("unmapped", 0) / len(reads),
                              4),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

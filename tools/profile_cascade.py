"""Stage-level timing of the GSNAP cascade on the bench workload.

Times (per 16384-read batch, median of N):
  ends   — align_batch_ends only (fast rung)
  full   — align_batch only (prevalent-diagonal rung on the whole batch)
  casc   — align_batch_cascaded (production path)

Run on the GPU (times from the CPU backend say nothing about it).
"""
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from tools import bench_data
from tpumap.gsnap.engine import (AlignConfig, align_batch,
                                 align_batch_cascaded, align_batch_ends)
from tpumap.index import GenomeDB, build_db
from tpumap.index.device import DeviceIndex
from tpumap.io.fasta import read_fasta
from tpumap.utils import dna

B = 16384
REPS = 12


def main():
    gfa, rfa = bench_data.ensure_files()
    dbdir = bench_data.ROOT / "db_k14"
    if (dbdir / "meta.json").exists():
        db = GenomeDB.load(str(dbdir))
    else:
        db = build_db(gfa, name="bench", k=14, interval=3)
        db.save(str(dbdir))
    index = DeviceIndex.from_host(db)
    config = AlignConfig(top_k=4, max_occ=4)

    reads = list(read_fasta(rfa))[:B]
    L = 112
    codes = np.zeros((B, L), dtype=np.uint8)
    nmask = np.zeros((B, L), dtype=bool)
    lengths = np.full(B, bench_data.READ_LEN, dtype=np.int32)
    for i, r in enumerate(reads):
        c, m = dna.encode(r.sequence)
        codes[i, :len(c)] = c
        nmask[i, :len(c)] = m
    batch = {"codes": jnp.asarray(codes), "nmask": jnp.asarray(nmask),
             "lengths": jnp.asarray(lengths)}

    def bench_fn(name, fn):
        out = fn()
        jax.block_until_ready(out)
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        med = statistics.median(ts)
        print(f"{name:6s} {med * 1e3:8.2f} ms/batch   "
              f"{B / med / 1e3:8.1f}k reads/s  (min {min(ts)*1e3:.2f})")
        return med

    bench_fn("ends", lambda: align_batch_ends(index, batch, config))
    bench_fn("full", lambda: align_batch(index, batch, config))
    bench_fn("casc", lambda: align_batch_cascaded(index, batch, config,
                                                  3, 256))


if __name__ == "__main__":
    main()

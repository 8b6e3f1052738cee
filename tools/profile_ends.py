"""Sub-stage timing of the fast rung (_ends_standard) on the bench
workload: cumulative pipelines jitted separately; differences give each
stage's cost. Run on the GPU."""
import pathlib
import statistics
import sys
import time
from functools import partial

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from tools import bench_data
from tpumap.gsnap import engine as E
from tpumap.index import GenomeDB, build_db
from tpumap.index.device import DeviceIndex
from tpumap.io.fasta import read_fasta
from tpumap.ops import pack, verify
from tpumap.utils import dna

B = 16384
REPS = 10


def stage_fns(config, k):
    occ = config.max_occ

    def cands_stage(index, batch):
        codes, nmask, lengths = (batch["codes"], batch["nmask"],
                                 batch["lengths"])
        Bb, L = codes.shape
        offsets_a, positions_a = index.mode_index(None)
        qlast = jnp.maximum(lengths - k, 0)
        qpos_list = [jnp.zeros_like(qlast), jnp.minimum(1, qlast),
                     jnp.minimum(2, qlast), jnp.maximum(qlast - 2, 0),
                     jnp.maximum(qlast - 1, 0), qlast]
        fwd_qpos = jnp.stack(qpos_list, axis=1)
        acc = jnp.zeros((Bb, L), jnp.uint32)
        for j in range(k):
            acc = (acc << 2) | jnp.roll(codes, -j, axis=1).astype(jnp.uint32)
        fwd_oligos = jnp.take_along_axis(acc, fwd_qpos.astype(jnp.int32),
                                         axis=1)
        rc_oligos = pack.revcomp_kmer(fwd_oligos, k)
        rc_qpos = jnp.maximum(
            (lengths[:, None] - k - fwd_qpos).astype(jnp.int32), 0)

        def gather_diags(oligos, qpos):
            start = jnp.take(offsets_a, oligos.astype(jnp.int32),
                             mode="clip")
            end = jnp.take(offsets_a, oligos.astype(jnp.int32) + 1,
                           mode="clip")
            count = (end - start).astype(jnp.int32)
            lane = jnp.arange(occ, dtype=jnp.int32)[None, None, :]
            idx = start.astype(jnp.int32)[..., None] + lane
            pos = jnp.take(positions_a, idx, mode="clip")
            ok = ((lane < count[..., None]) & (count <= occ)[..., None]
                  & (lengths >= k)[:, None, None])
            diag = pos - qpos[..., None].astype(jnp.uint32)
            bad = ~ok | (pos < qpos[..., None].astype(jnp.uint32))
            return jnp.where(bad, jnp.uint32(0xFFFFFFFF),
                             diag).reshape(Bb, 6 * occ)

        raw_f = gather_diags(fwd_oligos, fwd_qpos)
        raw_r = gather_diags(rc_oligos, rc_qpos)
        return raw_f, raw_r

    def dedup_stage(index, batch):
        raw_f, raw_r = cands_stage(index, batch)
        return (E._dedup_lanes(raw_f, E.ENDS_K),
                E._dedup_lanes(raw_r, E.ENDS_K))

    def pack_stage(index, batch):
        f, r = dedup_stage(index, batch)
        codes, nmask, lengths = (batch["codes"], batch["nmask"],
                                 batch["lengths"])
        packed = pack.pack_reads(codes)
        nmask2 = pack.pack_reads(nmask.astype(jnp.uint8))
        rc_packed = pack.revcomp_packed(packed, lengths)
        rc_nmask2 = pack.revcomp_packed(nmask2, lengths, complement=False)
        return f, r, packed, nmask2, rc_packed, rc_nmask2

    def probe_stage(index, batch):
        f, r, packed, nmask2, rc_packed, rc_nmask2 = pack_stage(index, batch)
        lengths = batch["lengths"]
        packed2 = jnp.concatenate([packed, rc_packed], axis=0)
        lengths2 = jnp.concatenate([lengths, lengths], axis=0)
        cands2 = jnp.concatenate([f, r], axis=0)
        kept = E._probe_rank(index, packed2, lengths2, cands2,
                             E.ENDS_VERIFY_K)
        return kept, packed2, lengths2, nmask2, rc_nmask2

    def verify_stage(index, batch):
        kept, packed2, lengths2, nmask2, rc_nmask2 = probe_stage(index, batch)
        nm2 = jnp.concatenate([nmask2, rc_nmask2], axis=0)
        nmm = verify.verify_diagonals(index, packed2, nm2, lengths2, kept)
        return kept, nmm

    def full_stage(index, batch):
        return E.align_batch_ends(index, batch, config)

    return {
        "cands": cands_stage,
        "dedup": dedup_stage,
        "pack": pack_stage,
        "probe": probe_stage,
        "verify": verify_stage,
        "ends": full_stage,
    }


def main():
    gfa, rfa = bench_data.ensure_files()
    dbdir = bench_data.ROOT / "db_k14"
    db = GenomeDB.load(str(dbdir)) if (dbdir / "meta.json").exists() \
        else build_db(gfa, name="bench", k=14, interval=3)
    index = DeviceIndex.from_host(db)
    config = E.AlignConfig(top_k=4, max_occ=4)

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

    prev = 0.0
    for name, fn in stage_fns(config, db.k).items():
        jfn = jax.jit(fn)
        out = jfn(index, batch)
        jax.block_until_ready(out)
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(jfn(index, batch))
            ts.append(time.perf_counter() - t0)
        med = statistics.median(ts)
        print(f"{name:8s} cum {med * 1e3:7.2f} ms   "
              f"(+{(med - prev) * 1e3:6.2f})")
        prev = med


if __name__ == "__main__":
    main()

"""Genome-sharded alignment: the gmapl/gsnapl (large-genome) axis.

The reference compiles separate gmapl/gsnapl binaries with 8-byte
univcoords for genomes >2^32 bp (src/Makefile.am:366, src/types.h:38-58,
src/univcoord.h). This equivalent avoids 64-bit device arithmetic
entirely: the genome is sharded into coordinate windows across
the `index` mesh axis, each window small enough that LOCAL coordinates fit
uint32 (the fast device currency); every device seeds + verifies the
(data-sharded, index-replicated) read batch against its own window, the
per-window results are all-gathered across devices and reduced to the global
best, and the host rebases (shard, local_diag) -> uint64 univcoord.

Windows overlap by `overlap` bases (>= max read length) so an alignment
crossing a window edge is complete in at least one window.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from tpumap.gsnap.engine import AlignConfig
from tpumap.index.build import GenomeDB, build_kmer_index
from tpumap.ops import pack, seed, verify
from tpumap.parallel.mesh import DATA_AXIS, INDEX_AXIS
from tpumap.utils import dna

INVALID = np.uint32(0xFFFFFFFF)


def shard_genome_host(db: GenomeDB, n_shards: int,
                      overlap: int = 1024) -> dict:
    """Split the genome into n_shards overlapping coordinate windows and
    build a per-window k-mer index with window-local uint32 positions.

    Returns host arrays with a leading shard dimension plus `bases`
    (uint64[n_shards]) for host-side coordinate rebasing.
    """
    L = db.genome_length
    span = (L + n_shards - 1) // n_shards
    span = (span + 15) & ~15                 # word-align window starts
    windows = []
    for s in range(n_shards):
        lo = min(s * span, L)
        hi = min(lo + span + overlap, L)
        windows.append((lo, hi))

    genomes, nmasks, offs, poss = [], [], [], []
    gmax = pmax = 0
    for lo, hi in windows:
        codes = db.get_codes(lo, hi - lo)
        nm = db.get_nmask(lo, hi - lo).astype(bool)
        o, p = build_kmer_index(codes, nm, db.k, db.interval)
        gp = dna.pack_2bit(codes)
        nmp = _pack_bits(nm)
        genomes.append(gp)
        nmasks.append(nmp)
        offs.append(o)
        poss.append(p)
        gmax = max(gmax, len(gp))
        pmax = max(pmax, len(p))
    gmax += 64
    nmax = gmax // 2 + 64
    pmax += 64
    genome_packed = np.zeros((n_shards, gmax), dtype=np.uint32)
    genome_nmask = np.full((n_shards, nmax), 0xFFFFFFFF, dtype=np.uint32)
    positions = np.full((n_shards, pmax), 0xFFFFFFFF, dtype=np.uint32)
    for s in range(n_shards):
        genome_packed[s, :len(genomes[s])] = genomes[s]
        genome_nmask[s, :len(nmasks[s])] = nmasks[s]
        genome_nmask[s, len(nmasks[s]):] = 0xFFFFFFFF
        positions[s, :len(poss[s])] = poss[s]
    return {
        "genome_packed": genome_packed,
        "genome_nmask": genome_nmask,
        "offsets": np.stack(offs),
        "positions": positions,
        "bases": np.asarray([w[0] for w in windows], dtype=np.uint64),
        "lengths": np.asarray([w[1] - w[0] for w in windows],
                              dtype=np.int64),
    }


def _pack_bits(mask: np.ndarray) -> np.ndarray:
    n = (len(mask) + 31) // 32
    out = np.zeros(n * 32, dtype=np.uint32)
    out[:len(mask)] = mask.astype(np.uint32)
    out = out.reshape(n, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (out << shifts).sum(axis=1, dtype=np.uint32)


def make_genome_sharded_aligner(mesh, db: GenomeDB, config: AlignConfig,
                                overlap: int = 1024):
    """(device_arrays, jitted align(arrays, batch) -> per-read results).

    Results carry `shard` + `diag` (window-local); use rebase_results for
    uint64 univcoords.
    """
    n_shards = mesh.shape[INDEX_AXIS]
    parts = shard_genome_host(db, n_shards, overlap)
    k = db.k

    idx_sh = NamedSharding(mesh, P(INDEX_AXIS))
    arrays = {name: jax.device_put(parts[name], idx_sh)
              for name in ("genome_packed", "genome_nmask",
                           "offsets", "positions")}

    def body(genome_packed, genome_nmask, offsets, positions,
             codes, nmask, lengths):
        genome_packed = genome_packed[0]
        genome_nmask = genome_nmask[0]
        offsets, positions = offsets[0], positions[0]

        class LocalIndex:
            pass
        li = LocalIndex()
        li.genome_packed = genome_packed
        li.genome_nmask = genome_nmask
        li.genomealt_packed = None

        rc_codes = pack.revcomp_codes(codes, lengths)
        rc_nmask = pack.revcomp_codes(
            jnp.where(nmask, jnp.uint8(0), jnp.uint8(3)),
            lengths) == jnp.uint8(3)

        def one_strand(c, m):
            oligos, valid = seed.query_oligos(c, m, lengths, k)
            NQ = oligos.shape[1]
            qpos = jnp.arange(NQ, dtype=jnp.int32)
            diags = seed.lookup_diagonals(offsets, positions, oligos, valid,
                                          qpos, config.max_occ)
            B = c.shape[0]
            diags, _ = seed.prevalent_diagonals(diags.reshape(B, -1),
                                                config.top_k)
            packed = pack.pack_reads(c)
            nmask2 = pack.pack_reads(m.astype(jnp.uint8))
            nmm = verify.verify_diagonals(li, packed, nmask2, lengths, diags)
            return diags, nmm

        fdiags, fnmm = one_strand(codes, nmask)
        rdiags, rnmm = one_strand(rc_codes, rc_nmask)
        B, K = fdiags.shape
        local_diags = jnp.concatenate([fdiags, rdiags], axis=1)
        local_nmm = jnp.concatenate([fnmm, rnmm], axis=1)
        strands = jnp.concatenate([jnp.zeros((B, K), jnp.int32),
                                   jnp.ones((B, K), jnp.int32)], axis=1)

        # global reduction across genome windows (device all-gather)
        shard_id = jax.lax.axis_index(INDEX_AXIS).astype(jnp.int32)
        g_diags = jax.lax.all_gather(local_diags, INDEX_AXIS, axis=0)
        g_nmm = jax.lax.all_gather(local_nmm, INDEX_AXIS, axis=0)
        g_str = jax.lax.all_gather(strands, INDEX_AXIS, axis=0)
        g_sh = jax.lax.all_gather(
            jnp.full((B, 2 * K), shard_id, jnp.int32), INDEX_AXIS, axis=0)
        S = g_diags.shape[0]
        KT = S * 2 * K
        g_diags = g_diags.transpose(1, 0, 2).reshape(B, KT)
        g_nmm = g_nmm.transpose(1, 0, 2).reshape(B, KT)
        g_str = g_str.transpose(1, 0, 2).reshape(B, KT)
        g_sh = g_sh.transpose(1, 0, 2).reshape(B, KT)

        key = g_nmm * jnp.int32(2 ** 16) + jnp.arange(KT, dtype=jnp.int32)
        order = jnp.argsort(key, axis=1)
        take = lambda a: jnp.take_along_axis(a, order, axis=1)
        nmm_s, diag_s, str_s, sh_s = (take(g_nmm), take(g_diags),
                                      take(g_str), take(g_sh))
        best_nmm = nmm_s[:, 0]
        best_diag = diag_s[:, 0]
        best_str = str_s[:, 0]
        best_sh = sh_s[:, 0]
        # windows overlap: the same alignment seen from two windows is a
        # duplicate (same strand, same GLOBAL coordinate). Detect via
        # identical nmm + strand with either same (shard, diag) or an
        # adjacent shard; conservative: same nmm+strand counts as dup for
        # n_best only when the global coord matches is resolved on host.
        dup = ((diag_s == best_diag[:, None]) & (sh_s == best_sh[:, None])
               & (str_s == best_str[:, None]))
        second = jnp.where(dup, jnp.int32(2 ** 15), nmm_s)
        second_nmm = jnp.min(second, axis=1)
        max_nmm = (lengths.astype(jnp.float32)
                   * config.max_mismatch_frac).astype(jnp.int32)
        mapped = (best_diag != INVALID) & (best_nmm <= max_nmm)
        return {"diag": best_diag, "shard": best_sh, "strand": best_str,
                "nmismatch": best_nmm, "second_nmismatch": second_nmm,
                "mapped": mapped}

    mapped_fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(INDEX_AXIS), P(INDEX_AXIS), P(INDEX_AXIS),
                  P(INDEX_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False)

    @jax.jit
    def align(arrays, batch):
        return mapped_fn(arrays["genome_packed"], arrays["genome_nmask"],
                         arrays["offsets"], arrays["positions"],
                         batch["codes"], batch["nmask"], batch["lengths"])

    return arrays, align, parts["bases"]


def rebase_results(results: dict, bases: np.ndarray) -> np.ndarray:
    """(shard, local diag) -> uint64 global univcoords (host side)."""
    shard = np.asarray(results["shard"])
    diag = np.asarray(results["diag"]).astype(np.uint64)
    return bases[shard] + diag

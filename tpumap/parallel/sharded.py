"""Index-sharded, data-parallel alignment over a (data, index) mesh.

This is the multi-device path (SURVEY.md §2.6 item 4): for genomes whose
k-mer positions array exceeds one chip's HBM, positions are sharded by
oligo range along the `index` mesh axis. Each device seeds its local read
shard against its local oligo range; candidate diagonals are then
all-gathered across the index axis (a device collective) so every device can
verify its own reads against the (replicated or sharded) genome.

The single-chip fast path (index replicated) is gsnap.engine.align_batch;
this module is its shard_map generalization, and reduces to it for an
index axis of size 1.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from tpumap.gsnap.engine import AlignConfig, select_best
from tpumap.index.build import GenomeDB
from tpumap.ops import pack, seed, verify
from tpumap.parallel.mesh import DATA_AXIS, INDEX_AXIS

INVALID = np.uint32(0xFFFFFFFF)


def shard_index_host(db: GenomeDB, n_shards: int) -> dict:
    """Split the k-mer index into n_shards contiguous oligo ranges.

    Returns host arrays with a leading shard dimension:
      offsets   uint32[n_shards, 4^k//n_shards + 1]  (rebased per shard)
      positions uint32[n_shards, Pmax]               (INVALID padded)
    """
    noligos = 4 ** db.k
    if noligos % n_shards:
        raise ValueError("4^k must divide by n_shards")
    span = noligos // n_shards
    offs, poss = [], []
    pmax = 0
    for s in range(n_shards):
        lo, hi = s * span, (s + 1) * span
        o = db.offsets[lo:hi + 1].astype(np.int64)
        p = db.positions[o[0]:o[-1]]
        offs.append((o - o[0]).astype(np.uint32))
        poss.append(p)
        pmax = max(pmax, len(p))
    pmax += 64  # gather overrun pad
    positions = np.full((n_shards, pmax), 0xFFFFFFFF, dtype=np.uint32)
    for s, p in enumerate(poss):
        positions[s, :len(p)] = p
    return {
        "offsets": np.stack(offs),
        "positions": positions,
        "span": span,
    }


def _shard_arrays(mesh, db: GenomeDB, pad_words: int):
    """Device arrays shared by both sharded builders: replicated genome,
    oligo-sharded offsets/positions."""
    parts = shard_index_host(db, mesh.shape[INDEX_AXIS])
    repl = NamedSharding(mesh, P())
    idx_sh = NamedSharding(mesh, P(INDEX_AXIS))
    arrays = {
        "genome_packed": jax.device_put(
            np.concatenate([db.genome_packed,
                            np.zeros(pad_words, np.uint32)]), repl),
        "genome_nmask": jax.device_put(
            np.concatenate([db.genome_nmask,
                            np.full(pad_words, 0xFFFFFFFF, np.uint32)]),
            repl),
        "offsets": jax.device_put(parts["offsets"], idx_sh),
        "positions": jax.device_put(parts["positions"], idx_sh),
    }
    return arrays, parts["span"]


def _strand_candidates(li, offsets, positions, k, span, config,
                       c, m, lengths):
    """One strand's candidate generation behind the oligo sharding:
    local-range seeding, all-gather of the union, prevalent-diagonal
    ranking, verification against the replicated genome."""
    oligos, valid = seed.query_oligos(c, m, lengths, k)
    shard_id = jax.lax.axis_index(INDEX_AXIS).astype(jnp.uint32)
    lo = shard_id * jnp.uint32(span)
    in_range = (oligos >= lo) & (oligos < lo + jnp.uint32(span))
    local_oligo = jnp.where(in_range, oligos - lo, 0)
    NQ = oligos.shape[1]
    qpos = jnp.arange(NQ, dtype=jnp.int32)
    local = seed.lookup_diagonals(offsets, positions, local_oligo,
                                  valid & in_range, qpos,
                                  config.max_occ)
    B = c.shape[0]
    local = local.reshape(B, -1)
    gathered = jax.lax.all_gather(local, INDEX_AXIS, axis=0)
    allc = gathered.transpose(1, 0, 2).reshape(B, -1)
    diags, _ = seed.prevalent_diagonals(allc, config.top_k)
    packed = pack.pack_reads(c)
    nmask2 = pack.pack_reads(m.astype(jnp.uint8))
    nmm = verify.verify_diagonals(li, packed, nmask2, lengths, diags)
    return diags, nmm


def _cascade_result(li, offsets, positions, k, span, config,
                    codes, nmask, lengths):
    """Both-strand sharded cascade -> select_best dict."""
    rc_codes = pack.revcomp_codes(codes, lengths)
    rc_nmask = pack.revcomp_codes(
        jnp.where(nmask, jnp.uint8(0), jnp.uint8(3)),
        lengths) == jnp.uint8(3)
    fdiags, fnmm = _strand_candidates(li, offsets, positions, k, span,
                                      config, codes, nmask, lengths)
    rdiags, rnmm = _strand_candidates(li, offsets, positions, k, span,
                                      config, rc_codes, rc_nmask,
                                      lengths)
    B, K = fdiags.shape
    all_diags = jnp.concatenate([fdiags, rdiags], axis=1)
    all_nmm = jnp.concatenate([fnmm, rnmm], axis=1)
    strands = jnp.concatenate([jnp.zeros((B, K), jnp.int32),
                               jnp.ones((B, K), jnp.int32)], axis=1)
    return select_best(all_diags, all_nmm, strands, lengths, config)



def make_sharded_aligner(mesh, db: GenomeDB, config: AlignConfig,
                         pad_words: int = 64):
    """Build (device_arrays, jitted fn(device_arrays, batch) -> results).

    device_arrays: genome replicated over the mesh; k-mer offsets/positions
    sharded along the index axis. batch arrays must be sharded along the
    data axis (or placed with the returned batch_sharding).
    """
    arrays, span = _shard_arrays(mesh, db, pad_words)
    k = db.k

    def body(genome_packed, genome_nmask, offsets, positions,
             codes, nmask, lengths):
        offsets, positions = offsets[0], positions[0]

        class LocalIndex:
            pass
        li = LocalIndex()
        li.genome_packed = genome_packed
        li.genome_nmask = genome_nmask

        return _cascade_result(li, offsets, positions, k, span, config,
                               codes, nmask, lengths)

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(INDEX_AXIS), P(INDEX_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False)

    @jax.jit
    def align(arrays, batch):
        return mapped(arrays["genome_packed"], arrays["genome_nmask"],
                      arrays["offsets"], arrays["positions"],
                      batch["codes"], batch["nmask"], batch["lengths"])

    return arrays, align


def make_sharded_full_aligner(mesh, db: GenomeDB, config: AlignConfig,
                              scoring=None, splicing: bool = True,
                              salvage: bool = False,
                              r_chain: int = 256, r_salv: int = 64,
                              r_indel: int = 64,
                              paired: bool = False, pairmax: int = 2000,
                              orientation: str = "FR",
                              pairexpect: int = 1000, pairdev: int = 100,
                              pad_words: int = 4352):
    """FULL-capability sharded-index aligner (SURVEY §2.6 item 4): an
    HBM-overflow index keeps the complete refinement ladder — cascade
    seeding per oligo shard, all-gather of candidate diagonals,
    then trim + chain-DP splices + salvage + banded-DP indels (and the
    paired concordance kernel) run LOCALLY on each data shard against
    the replicated genome (ladder.refine_full; no further collectives).

    Returns (device_arrays, jitted fn(device_arrays, batch) -> the
    align_batch_full/align_pair_full result dict, data-sharded).
    """
    from tpumap.gsnap.engine import _trim_stage
    from tpumap.gsnap import ladder
    from tpumap.ops import pathdp

    if scoring is None:
        scoring = pathdp.PathScoring()
    arrays, span = _shard_arrays(mesh, db, pad_words)
    k = db.k
    chrom_offsets = np.asarray(db.chrom_offsets, np.uint32)
    genome_length = int(db.genome_length)
    has_n = bool(np.any(db.genome_nmask))

    def body(genome_packed, genome_nmask, offsets, positions,
             codes, nmask, lengths):
        offsets, positions = offsets[0], positions[0]
        # a real DeviceIndex (registered pytree) so the jitted
        # refinement kernels (chain_solve, refine_indels) accept it
        from tpumap.index.device import DeviceIndex
        li = DeviceIndex(
            genome_packed=genome_packed, genome_nmask=genome_nmask,
            offsets=offsets, positions=positions,
            chrom_offsets=jnp.asarray(chrom_offsets),
            genome_length=genome_length, k=k, genome_has_n=has_n,
            interval=int(getattr(db, "interval", 3)))

        B, L = codes.shape
        res = _cascade_result(li, offsets, positions, k, span, config,
                              codes, nmask, lengths)
        if config.soft_clips:
            res.update(_trim_stage(li, codes, nmask, lengths, res,
                                   config))
        pbatch = {"packed": pack.pack_reads(codes),
                  "pnmask": pack.pack_reads(nmask.astype(jnp.uint8)),
                  "lengths": lengths}
        out = ladder.refine_full(
            li, pbatch, res, config, L, scoring, splicing, salvage,
            min(r_chain, B), min(r_salv, B), min(r_indel, B),
            keep_cands=paired)
        # compacted-row indices are LOCAL to this data shard; globalize
        # so the host consumers see batch-row indices after the
        # out_specs concatenation
        row0 = (jax.lax.axis_index(DATA_AXIS).astype(jnp.int32) * B)
        for key in ("ch_idx", "in_idx", "amb_idx", "sec_idx"):
            if key in out:
                out[key] = out[key] + row0
        # scalar diagnostics can't ride the P(DATA_AXIS) out_specs
        for key in ("indel_tb_overflow", "stage2_overflow",
                    "amb_row_overflow", "amb_task_overflow",
                    "sec_overflow"):
            out.pop(key, None)
        if paired:
            from tpumap.gsnap.paired import concordance_device
            cd, cs, cn = (out.pop("cand_diags"), out.pop("cand_strands"),
                          out.pop("cand_nmm"))
            ci, cj, valid, insert = concordance_device(
                cd[0::2], cs[0::2], cn[0::2], lengths[0::2],
                cd[1::2], cs[1::2], cn[1::2], lengths[1::2],
                pairmax, orientation, pairexpect, pairdev)
            take = lambda a, i: jnp.take_along_axis(
                a, i[:, None], axis=1)[:, 0]
            out.update(pe_ci=ci, pe_cj=cj, pe_valid=valid,
                       pe_insert=insert,
                       pe_cd1=take(cd[0::2], ci),
                       pe_cs1=take(cs[0::2], ci),
                       pe_cn1=take(cn[0::2], ci),
                       pe_cd2=take(cd[1::2], cj),
                       pe_cs2=take(cs[1::2], cj),
                       pe_cn2=take(cn[1::2], cj))
        return out

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(INDEX_AXIS), P(INDEX_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False)

    @jax.jit
    def align(arrays, batch):
        return mapped(arrays["genome_packed"], arrays["genome_nmask"],
                      arrays["offsets"], arrays["positions"],
                      batch["codes"], batch["nmask"], batch["lengths"])

    return arrays, align

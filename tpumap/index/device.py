"""Device-resident genome index.

The device-memory image of a GenomeDB: packed genome words, N-flag
bitmap, k-mer offsets/positions, chromosome offsets — the equivalent of the
reference's mmap'd indexdb + genomebits (src/indexdb.c, src/genomebits.h),
loaded once per process with jax.device_put (optionally with a sharding).

All arrays are padded so downstream gathers can read one-past-the-end
without bounds checks (the reference pads its genome blocks similarly).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpumap.index.build import GenomeDB

# univdiagonal convention: diag = genomic position of query base 0.
# Candidates are stored as uint32; INVALID_DIAG marks padding lanes.
INVALID_DIAG = np.uint32(0xFFFFFFFF)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceIndex:
    genome_packed: jax.Array    # uint32[W16+pad] 16 bases/word
    genome_nmask: jax.Array     # uint32[W32+pad] 1 bit/base
    offsets: jax.Array          # uint32[4^k+1]
    positions: jax.Array        # uint32[P+pad]
    chrom_offsets: jax.Array    # uint32[nchrom+1]
    genome_length: int          # static
    k: int                      # static
    genome_has_n: bool = True   # static: False lets verify skip the
    #                             genome N-mask window gather entirely
    interval: int = 3           # static: positions sampling interval —
    #                             the ends rung probes `interval` query
    #                             offsets per read end (1 with a dense
    #                             interval-1 index: 3x fewer seed
    #                             gathers, 3x the positions HBM)
    # mode-transformed (offsets, positions) pairs, space -> arrays
    alt_offsets: dict = None
    alt_positions: dict = None
    # SNP tolerance: alternate genome (genomealt); a base matches if it
    # matches EITHER the reference or the alt allele (src/gsnap.c:3380-3394)
    genomealt_packed: jax.Array = None

    def tree_flatten(self):
        alt_keys = tuple(sorted(self.alt_offsets or {}))
        children = (self.genome_packed, self.genome_nmask, self.offsets,
                    self.positions, self.chrom_offsets,
                    tuple((self.alt_offsets or {})[s] for s in alt_keys),
                    tuple((self.alt_positions or {})[s] for s in alt_keys),
                    (self.genomealt_packed,) if self.genomealt_packed
                    is not None else ())
        return children, (self.genome_length, self.k, alt_keys,
                          self.genome_has_n, self.interval)

    @classmethod
    def tree_unflatten(cls, aux, children):
        *main, alt_off, alt_pos, galt = children
        alt_keys = aux[2]
        return cls(*main,
                   genome_length=aux[0], k=aux[1],
                   genome_has_n=aux[3],
                   interval=aux[4] if len(aux) > 4 else 3,
                   alt_offsets=dict(zip(alt_keys, alt_off)) or None,
                   alt_positions=dict(zip(alt_keys, alt_pos)) or None,
                   genomealt_packed=galt[0] if galt else None)

    def mode_index(self, space: str | None):
        """(offsets, positions) for a base space (None = standard)."""
        if space is None or not self.alt_offsets or space not in self.alt_offsets:
            return self.offsets, self.positions
        return self.alt_offsets[space], self.alt_positions[space]

    @classmethod
    def from_host(cls, db: GenomeDB, device=None,
                  pad_words: int | None = None) -> "DeviceIndex":
        # pad_words covers the widest FIXED window fetched as one dynamic
        # slice (a 65,536 bp localscan window = 4,097 words), so those
        # slices never clamp for in-genome starts; wider windows (GMAP
        # region buckets) are handled inside ops/verify.py
        # extract_packed_window by zero-extending the operand.
        if pad_words is None:
            from tpumap.ops.verify import SAFE_PAD_WORDS
            pad_words = SAFE_PAD_WORDS
        if db.positions.dtype != np.uint32:
            raise ValueError(
                "genome exceeds the uint32 coordinate space (gsnapl "
                "scale); use parallel/large.py window sharding, which "
                "rebases each shard to local uint32 coordinates")
        put = partial(jax.device_put, device=device)
        gp = np.concatenate([db.genome_packed,
                             np.zeros(pad_words, dtype=np.uint32)])
        nm = np.concatenate([db.genome_nmask,
                             np.full(pad_words, 0xFFFFFFFF, dtype=np.uint32)])
        pos = np.concatenate([db.positions,
                              np.full(pad_words, INVALID_DIAG, dtype=np.uint32)])
        alt_off, alt_pos = {}, {}
        for space, (off, p) in (db.mode_indexes or {}).items():
            alt_off[space] = put(off)
            alt_pos[space] = put(np.concatenate(
                [p, np.full(pad_words, INVALID_DIAG, dtype=np.uint32)]))
        galt = None
        if db.genomealt_packed is not None:
            galt = put(np.concatenate([db.genomealt_packed,
                                       np.zeros(pad_words, dtype=np.uint32)]))
        return cls(
            genome_packed=put(gp),
            genome_nmask=put(nm),
            offsets=put(db.offsets),
            positions=put(pos),
            chrom_offsets=put(db.chrom_offsets.astype(np.uint32)),
            genome_length=db.genome_length,
            k=db.k,
            genome_has_n=bool(db.genome_nmask.any()),
            interval=int(getattr(db, "interval", 3)),
            alt_offsets=alt_off or None,
            alt_positions=alt_pos or None,
            genomealt_packed=galt,
        )

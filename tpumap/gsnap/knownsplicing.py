"""Known splice sites (the -s/--use-splicing path).

Equivalent of the reference's Knownsplicing_T built from a splicing map
IIT (src/knownsplicing.c Knownsplicing_from_splicing_iit:892-985,
src/gsnap.c:3534-3608): four sorted coordinate sets — donor, acceptor,
antidonor, antiacceptor — in 0-based univcoord space, where a donor
coordinate is the first intron base after the exon and an acceptor
coordinate is the first exon base after the intron.

Site-level maps carry typed 2-bp entries (">label chr:p..p+1 donor|
acceptor", sign from coordinate order); intron-level maps (e.g. from
gff3_introns) carry full-intron intervals treated as donor..acceptor
pairs. On device the sets become sorted uint32 arrays queried with
searchsorted (replacing the reference's EF64 rank/select bitvectors,
src/knownsplicing.c:58-80 — binary search over device-resident sorted
arrays vectorizes better than succinct bitvector rank).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_EMPTY = np.zeros(0, dtype=np.uint64)


@dataclass
class KnownSplicing:
    donor: np.ndarray = field(default_factory=lambda: _EMPTY)
    acceptor: np.ndarray = field(default_factory=lambda: _EMPTY)
    antidonor: np.ndarray = field(default_factory=lambda: _EMPTY)
    antiacceptor: np.ndarray = field(default_factory=lambda: _EMPTY)
    # paired junctions (the reference's *_partners): [J, 2] arrays of
    # (left, right) boundary univcoords — left = first intron base,
    # right = first exon base after the intron — sorted by left coord.
    # junctions carries plus-sense (GT-AG side) introns, anti_junctions
    # antisense ones. Used to DERIVE the partner diagonal for reads whose
    # second exon anchor is too short to seed (src/knownsplicing.c:59-80)
    junctions: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.uint64))
    anti_junctions: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.uint64))

    def __post_init__(self):
        for name in ("donor", "acceptor", "antidonor", "antiacceptor"):
            arr = np.asarray(getattr(self, name), dtype=np.uint64)
            setattr(self, name, np.unique(arr))
        for name in ("junctions", "anti_junctions"):
            arr = np.asarray(getattr(self, name), dtype=np.uint64).reshape(-1, 2)
            order = np.lexsort((arr[:, 1], arr[:, 0]))
            setattr(self, name, arr[order])

    @property
    def nsites(self) -> int:
        return (len(self.donor) + len(self.acceptor) + len(self.antidonor)
                + len(self.antiacceptor))

    # ------------------------------------------------------------------

    @classmethod
    def from_splicing_iit(cls, iit, db, intron_level: bool | None = None
                          ) -> "KnownSplicing":
        """Build from a splicing map IIT + GenomeDB chromosome table.

        Mirrors src/knownsplicing.c:892-985: typed donor/acceptor entries
        give site-level knowledge; if the IIT has no donor/acceptor types
        (or intron_level is forced) every interval is treated as a full
        donor..acceptor intron.
        """
        donor_t = iit.typeint("donor")
        acceptor_t = iit.typeint("acceptor")
        if intron_level is None:
            intron_level = donor_t < 0 or acceptor_t < 0
        chrom_off = {name: int(db.chrom_offsets[i])
                     for i, name in enumerate(db.chrom_names)}
        d, a, ad, aa = [], [], [], []
        junc, anti_junc = [], []
        for divno, divname in enumerate(iit.divs):
            if divname not in chrom_off:
                continue
            off = chrom_off[divname]
            dd = iit.divdata[divno]
            for r in range(len(dd)):
                # interval lows are 1-based; chroffset + low = 0-based
                # coordinate one past the exon end (src/knownsplicing.c:916)
                low = off + int(dd.lows[r])
                high = off + int(dd.highs[r]) - 1
                sign = int(dd.signs[r])
                if intron_level:
                    if sign >= 0:
                        d.append(low)
                        a.append(high)
                        junc.append((low, high))
                    else:
                        ad.append(high)
                        aa.append(low)
                        anti_junc.append((low, high))
                elif int(dd.types[r]) == donor_t:
                    (d if sign >= 0 else ad).append(low)
                elif int(dd.types[r]) == acceptor_t:
                    (a if sign >= 0 else aa).append(low)
        return cls(donor=np.asarray(d, dtype=np.uint64),
                   acceptor=np.asarray(a, dtype=np.uint64),
                   antidonor=np.asarray(ad, dtype=np.uint64),
                   antiacceptor=np.asarray(aa, dtype=np.uint64),
                   junctions=np.asarray(junc, dtype=np.uint64).reshape(-1, 2),
                   anti_junctions=np.asarray(anti_junc,
                                             dtype=np.uint64).reshape(-1, 2))

    @classmethod
    def from_junctions(cls, donor_coords, acceptor_coords, senses
                       ) -> "KnownSplicing":
        """Build from observed junctions (two-pass learning, the
        Path_learn_* -> Knownsplicing_new path, src/gsnap.c:4340-4352).

        donor_coords[i] = univcoord of the first intron base (left edge),
        acceptor_coords[i] = univcoord of the first exon base after the
        intron (right edge), senses[i] = +1 (GT-AG side) / -1 (antisense).
        """
        donor_coords = np.asarray(donor_coords, dtype=np.uint64)
        acceptor_coords = np.asarray(acceptor_coords, dtype=np.uint64)
        senses = np.asarray(senses)
        plus = senses >= 0
        return cls(donor=donor_coords[plus],
                   acceptor=acceptor_coords[plus],
                   antiacceptor=donor_coords[~plus],
                   antidonor=acceptor_coords[~plus],
                   junctions=np.stack([donor_coords[plus],
                                       acceptor_coords[plus]], axis=1),
                   anti_junctions=np.stack([donor_coords[~plus],
                                            acceptor_coords[~plus]], axis=1))

    # ------------------------------------------------------------------
    # dump/load (the --splices-dump/--splices-read analog,
    # src/gsnap.c:655-658)

    def dump(self, path: str) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 donor=self.donor, acceptor=self.acceptor,
                 antidonor=self.antidonor, antiacceptor=self.antiacceptor,
                 junctions=self.junctions,
                 anti_junctions=self.anti_junctions)

    @classmethod
    def load(cls, path: str) -> "KnownSplicing":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        kw = {}
        for name in ("junctions", "anti_junctions"):
            if name in z:
                kw[name] = z[name]
        return cls(donor=z["donor"], acceptor=z["acceptor"],
                   antidonor=z["antidonor"], antiacceptor=z["antiacceptor"],
                   **kw)

    def derived_pairs(self, diag: int, qlen: int, max_intron: int):
        """Candidate (diagA, diagB) pairs implied by known junctions whose
        left boundary falls inside a read anchored on diagonal `diag`:
        the partner diagonal is diag + intron_length, no seeding needed
        (the knownsplicing partner-lookup, src/path-solve.c known-splice
        resolution)."""
        out = set()
        for arr in (self.junctions, self.anti_junctions):
            if not len(arr):
                continue
            # read anchored on the LEFT exon: junction left boundary D in
            # (diag, diag+qlen) => partner diagonal diag + intron
            lo = np.searchsorted(arr[:, 0], diag + 1)
            hi = np.searchsorted(arr[:, 0], diag + qlen)
            for j in range(int(lo), int(hi)):
                intron = int(arr[j, 1]) - int(arr[j, 0])
                if 0 < intron <= max_intron:
                    out.add((diag, diag + intron))
            # read anchored on the RIGHT exon: junction right boundary A in
            # (diag, diag+qlen) => partner diagonal diag - intron
            rs = arr[np.argsort(arr[:, 1], kind="stable")]
            lo = np.searchsorted(rs[:, 1], diag + 1)
            hi = np.searchsorted(rs[:, 1], diag + qlen)
            for j in range(int(lo), int(hi)):
                intron = int(rs[j, 1]) - int(rs[j, 0])
                if 0 < intron <= max_intron and diag >= intron:
                    out.add((diag - intron, diag))
        return sorted(out)

    # ------------------------------------------------------------------

    def to_device(self):
        """Sorted uint32 device arrays (empty sets become a single
        impossible sentinel so the jit signature stays membership-safe).

        Besides the four site-membership sets, ships the junction PAIR
        table in two sorted views (by left and by right boundary) with
        intron lengths, so the fused ladder can derive partner
        diagonals ON DEVICE (the derived_pairs analog; src/path-solve.c
        known-splice resolution)."""
        import jax.numpy as jnp

        def dev(arr):
            if len(arr) == 0:
                arr = np.asarray([0xFFFFFFFF], dtype=np.uint64)
            return jnp.asarray(arr.astype(np.uint32))

        pairs = np.concatenate(
            [np.asarray(self.junctions, np.uint64).reshape(-1, 2),
             np.asarray(self.anti_junctions, np.uint64).reshape(-1, 2)],
            axis=0)
        if len(pairs) == 0:
            pairs = np.asarray([[0xFFFFFFFF, 0xFFFFFFFF]], np.uint64)
        intron = (pairs[:, 1].astype(np.int64)
                  - pairs[:, 0].astype(np.int64)).astype(np.int64)
        lorder = np.argsort(pairs[:, 0], kind="stable")
        rorder = np.argsort(pairs[:, 1], kind="stable")
        return {"donor": dev(self.donor), "acceptor": dev(self.acceptor),
                "antidonor": dev(self.antidonor),
                "antiacceptor": dev(self.antiacceptor),
                "jleft": jnp.asarray(
                    pairs[lorder, 0].astype(np.uint32)),
                "jleft_intron": jnp.asarray(
                    intron[lorder].astype(np.int32)),
                "jright": jnp.asarray(
                    pairs[rorder, 1].astype(np.uint32)),
                "jright_intron": jnp.asarray(
                    intron[rorder].astype(np.int32))}


def coords_in_set(sorted_set, coords):
    """Vectorized membership: True where coords appear in sorted_set."""
    import jax.numpy as jnp
    if sorted_set.shape[0] == 0:
        return jnp.zeros(coords.shape, jnp.bool_)
    idx = jnp.searchsorted(sorted_set, coords)
    idx = jnp.minimum(idx, sorted_set.shape[0] - 1)
    return jnp.take(sorted_set, idx) == coords

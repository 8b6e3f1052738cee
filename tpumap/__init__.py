"""tpumap — a batched spliced alignment framework in JAX.

A ground-up reimplementation of the capabilities of GMAP/GSNAP (reference:
GMAP version 2024-02-22) for an accelerator: the genome k-mer index lives
in device memory, and seed finding / diagonal merging / mismatch
verification / banded affine-gap DP / path solving run as batched JAX ops
over thousands of reads at a time, compiled by XLA; scale-out is
expressed with `jax.sharding` meshes rather than worker threads.  The
host side (FASTA/FASTQ tokenizing, SAM emission) is native C++.

Package layout:
  tpumap.index     genome database build + load (host numpy + device arrays)
  tpumap.ops       device ops: pack/seed/verify/dp/pathdp/localscan/chain
  tpumap.gsnap     short-read engine (method-ladder-as-cascade)
  tpumap.gmap      long cDNA engine (region finding, chaining, structure)
  tpumap.io        FASTA/FASTQ input, SAM/GFF3/alignment/PSL/m8 printers
  tpumap.parallel  device mesh setup, sharded pipelines
  tpumap.cli       command-line drivers mirroring gmap/gsnap/gmap_build
"""

__version__ = "0.1.0"
REFERENCE_VERSION = "2024-02-22"

from tpumap.utils import jaxcache as _jaxcache

_jaxcache.enable()

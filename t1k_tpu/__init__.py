"""t1k_tpu — a GPU-accelerated KIR/HLA genotyping framework in JAX.

A from-scratch reimplementation of the capabilities of mourisl/T1K
(Song et al., Genome Res 2023) with its bulk compute on an accelerator:

  * candidate reads are k-mer classified against the allele database
    (IPD-IMGT/HLA, IPD-KIR, or custom references),
  * scored with a batched banded affine-gap aligner (a jitted device DP,
    with a native C++ host engine for CPU-only runs and bit-exact parity),
  * allele abundances are inferred by SQUAREM-accelerated EM over the
    read-group x equivalence-class matrix (jitted, psum-ready for
    multi-host meshes),
  * followed by allele selection, quality scoring, novel-SNP calling and
    single-cell barcode matrices.

Layering (host -> device):
  io/        FASTQ/FASTA/BAM ingestion, reference packing, output writers
  native/    C++ host engine: seed/chain/banded-DP/extend + EM inner loop
  ops/       device ops: k-mer screen, banded aligner, jitted EM
  core/      pipeline stages: extractor, seqset, fragment, genotyper,
             variant caller, barcodes
  parallel/  mesh construction and multi-chip sharded EM
  db/        reference database construction (EMBL-ENA .dat -> FASTA)
  cli/       command-line entry points (run pipeline / stages)
  tools/     cohort aggregation (merge, copy number, smart-seq)
"""

__version__ = "0.1.0"

"""hichap_master_tpu_torch — the PyTorch/CUDA port of hichap_master_tpu.

What is ported: the analysis suite (dense per-chromosome ICE, genome-wide
block-sparse ICE, HICCUPS loop calling, the two-step correction,
compartments and TADs), the filtering stage (``pipeline.filtering``:
duplicate removal, Hi-C noise classes and the maternal/paternal
assignment, chunk beds in, allelic beds out) and the contact-matrix stage
that feeds on it
(``pipeline.matrix``: binning of valid or allelic pairs, the haplotype
imputation vote, the genome-wide and local corrections and the ICE weights,
with the hybrid tile + scattered-COO balance past the dense cap).  Plain
tensor code is PyTorch; every kernel is hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use: the three the JAX package
wrote in Pallas (K1-K3) and four port-only ones (K4/K5 for the TAD HMM's
recurrences, K6 the sparse imputation vote, K7 the scattered marginal).  On
a CPU tensor every kernel wrapper runs its plain PyTorch version instead,
which is what the parity tests against the JAX package exercise.

Entry points take arrays in memory and an explicit ``device``; the file
drivers (``pipeline.matrix.haplotype_matrix_files`` /
``traditional_matrix_files``, ``models.*.run_*``) read beds and read and
write coolers through ``io`` (a host C++ bed scanner and a minimal HDF5
writer and reader in numpy: no pandas, no h5py; the reader also reads the
``cooler`` package's chunked, compressed files).  The command line
``hichap-torch`` (``cli``) runs the sub-commands of the JAX package's
``hichap-tpu`` from ``filtering`` on.  The package never imports ``jax``, nor
anything of the JAX package.
"""

from .device import set_precision

set_precision()

__version__ = "0.1.0"

"""Tensor ops of the port (counterparts of ``hichap_master_tpu.ops``), with
the names that the JAX package's ``ops`` exports."""

from .masked import (
    masked_max,
    masked_mean,
    masked_median,
    masked_min,
    masked_percentile,
    masked_var,
    valid_row_mask,
)
from .correct import (
    coverage,
    gap_mask,
    gap_mask_lowres,
    trans2symmetry,
    correct_vc,
    two_step_correction,
    two_step_correction_batch,
    genomewide_alpha,
    genomewide_correction,
)
from .balance import balanced_matrix, ice_balance, ice_balance_batch
from .binning import (
    bin_genomewide,
    bin_intra,
    bin_intra_single_side,
    stream_chunks,
)
from .imputation import disk_offsets, impute_inter_chunk
from .expected import (
    correlation_matrix,
    default_compartment_gap,
    distance_decay,
    oe_matrix,
    oe_matrix_sliding,
)
from .pca import pca_components, pca_components_eigh, pca_components_subspace
from .pc_select import select_pc_new_device
from .di import directionality_index, tad_gap_mask
from .hmm import GMMHMM, baum_welch, baum_welch_fused, viterbi
from .stats import bh_fdr, isotonic_fit, poisson_sf, ttest_rel

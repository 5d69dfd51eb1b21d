"""Kernel plumbing of the port that runs without a GPU: the build cache key,
the missing-toolkit error, and the wrappers' refusal to fall back to the
plain version for a device that is not the CPU."""

import pytest
import torch

from hichap_master_tpu_torch.kernels import _build
from hichap_master_tpu_torch.kernels import hmm_scan
from hichap_master_tpu_torch.kernels.escalation import (escalation_batch,
                                                        ladder, prefix_maps)
from hichap_master_tpu_torch.kernels.ice_sweep import IceState, ice_sweeps
from hichap_master_tpu_torch.kernels.intra_bin import intra_bin
from hichap_master_tpu_torch.kernels.sparse_marginal import block_sym_matvec

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)


def test_every_entry_point_has_a_source():
    srcs = "".join(p.read_text() for p in _build.sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in srcs, name
    assert {p.name for p in _build.sources()} >= {
        "ice_sweep.cu", "sparse_marginal.cu", "escalation.cu",
        "hmm_scan.cu", "impute_vote.cu", "segment_marginal.cu"}


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text("int x;")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    (tmp_path / "a.cu").write_text("int y;")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_launch_error_code_raises():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        _build.check(9, "k")


def test_wrappers_do_not_fall_back_off_the_cpu():
    meta = torch.device("meta")
    tiles = torch.empty(2, 128, 128, device=meta)
    idx = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="no block-sparse"):
        block_sym_matvec(tiles, idx, idx, torch.empty(128, device=meta),
                         R=1, T=128)
    st = IceState.start(torch.ones(1, 8, device=meta), 3)
    with pytest.raises(RuntimeError, match="no ICE kernel"):
        ice_sweeps(torch.empty(1, 8, 8, device=meta), st, iters=1, tol=0.0,
                   max_iters=3)
    D = torch.empty(1, 4, 8, device=meta)
    p = torch.empty(1, 3, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="no escalation kernel"):
        escalation_batch(D, D, D, p, p, p.bool(), 1, 2, 1, 2, 0, 0)


def test_hmm_wrappers_do_not_fall_back_off_the_cpu():
    meta = torch.device("meta")
    x = torch.empty(2, 8, 3, dtype=torch.float64, device=meta)
    m = torch.empty(3, 3, dtype=torch.float64, device=meta)
    v = torch.empty(3, dtype=torch.float64, device=meta)
    L = torch.empty(2, dtype=torch.int64, device=meta)
    with pytest.raises(RuntimeError, match="no HMM kernel"):
        hmm_scan.forward_backward(x, m, v, L)
    with pytest.raises(RuntimeError, match="no HMM kernel"):
        hmm_scan.viterbi(x, m, v, L)


def test_k3_parts_do_not_fall_back_off_the_cpu():
    meta = torch.device("meta")
    D = torch.empty(1, 4, 8, device=meta)
    with pytest.raises(RuntimeError, match="no escalation kernel"):
        prefix_maps(D, D, D)
    W = torch.empty(3, 1, 4, 8, device=meta)
    mask = torch.empty(1, 4, 8, dtype=torch.uint8, device=meta)
    with pytest.raises(RuntimeError, match="no ladder kernel"):
        ladder(W, mask, 1, 2, 1)


def test_intra_bin_does_not_fall_back_off_the_cpu():
    meta = torch.device("meta")
    cols = [torch.zeros(4, dtype=torch.int64, device=meta)] * 4
    table = torch.zeros(2, dtype=torch.int64, device=meta)
    with pytest.raises(RuntimeError, match="no intra binning kernel"):
        intra_bin(torch.zeros(8, device=meta), *cols, table, table, 1000)

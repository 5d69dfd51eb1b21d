"""What decides ``correct`` fails what it must: the control (the reference
computed in bfloat16, one precision below the configuration's float32,
put in the program's place) and the run with the timed path broken
underneath both come out not correct, at a tiny size on the CPU.  On a
card, the control at the cells' own size (``chip`` marker)."""

import pytest
import torch

from hicbench import compare, jobs, manifest

CELLS = ["deep_traditional", "deep_balance", "diploid_matrix"]
# the cells of BENCHMARK.json, run on the card at their own size
CHIP_CELLS = ["deep_traditional", "deep_balance"]


def _job(here, bench, cell, seed, device="cpu"):
    w = manifest.cell(cell, bench)
    return jobs.Job(manifest.config(w["config"], here),
                    manifest.traffic(w["traffic"], here), seed,
                    torch.device(device))


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**32 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_here, cell, seed):
    here, bench = tiny_here
    nums = compare.control(_job(here, bench, cell, seed))
    ok, rows = compare.verdict(nums, manifest.limits(cell, here))
    assert not ok, rows


def _state_unchanged(mp):
    """ICE returns the state it started from: K1 iterates nothing and the
    hybrid balance stops before its first iteration."""
    from hichap_master_tpu_torch.ops import balance, sparse_hybrid

    mp.setattr(balance, "ice_sweeps", lambda *a, **k: None)
    real = sparse_hybrid.ice_iterate
    mp.setattr(sparse_hybrid, "ice_iterate",
               lambda matvec, keep, **k: real(matvec, keep, tol=k["tol"],
                                              max_iters=0))


def _half_left_out(mp):
    """Every block of pairs the stage moves loses its second half."""
    from hichap_master_tpu_torch.pipeline import matrix

    real = matrix._columns
    mp.setattr(matrix, "_columns",
               lambda part, device: tuple(c[:(c.numel() + 1) // 2]
                                          for c in real(part, device)))


def _answer_altered(mp):
    """One weight of each balance is off by a thousandth where it is
    made."""
    from hichap_master_tpu_torch.pipeline import matrix

    real = matrix.matrix_weights

    def altered(*a, **k):
        w, st = real(*a, **k)
        w = w.clone()
        i = int(torch.nonzero(torch.isfinite(w))[0])
        w[i] *= 1.001
        return w, st

    mp.setattr(matrix, "matrix_weights", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(tiny_here, monkeypatch, cell,
                                          fault):
    import run

    here, bench = tiny_here
    fault(monkeypatch)
    r = run.run_cell(bench, cell, 2**31 + 17, 0.1, False, "cpu", here=here)
    assert not r["correct"], r["checks"]
    assert r["failed"] == r["attempted"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CHIP_CELLS)
def test_control_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = manifest.manifest()
    nums = compare.control(_job(manifest.HERE, bench, cell, 2**31 + 1,
                                "cuda"))
    ok, rows = compare.verdict(nums, manifest.limits(cell))
    assert not ok, rows

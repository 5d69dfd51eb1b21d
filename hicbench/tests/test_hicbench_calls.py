"""K2 and K7 calls counted, not worked out from the ICE iterations: the
port's kernel wrappers count their launches, ``run.launches_since``
reads the counts around the traced job, and a hybrid balance that stops
after k iterations, k not a multiple of ``ops/sparse.CHECK_EVERY``,
calls K2 ``4 ceil(k / 4) + 2`` times and K7 ``4 ceil(k / 4) + 1`` times.
On a card (``chip`` marker) the counts are the wrappers' own."""

import math
import sys
import types

import pytest
import torch

K2 = "sparse_marginal.block_sym_matvec"
K7 = "segment_marginal.segment_marginal"


def _layout(device):
    """A hybrid layout of 300 bins (three block rows of 128): a band of
    dense tiles on the diagonal and scattered long-range pixels."""
    from hichap_master_tpu_torch.ops.sparse_hybrid import hybrid_from_coo

    g = torch.Generator().manual_seed(5)
    n = 300
    r, c = torch.triu_indices(n, n)
    near = (c - r) < 12
    far = torch.rand(r.numel(), generator=g) < 0.02
    keep = near | far
    r, c = r[keep], c[keep]
    v = torch.randint(1, 50, (r.numel(),), generator=g)
    return hybrid_from_coo(r.to(device), c.to(device), v.to(device), n,
                           min_tile_occ=800, assume_unique=True)


def _tol_stopping_at(h, k, **kw):
    """A tolerance at which the balance stops after iteration k: between
    the variance after k - 1 iterations and after k."""
    from hichap_master_tpu_torch.ops.sparse_hybrid import ice_balance_hybrid

    v = [float(ice_balance_hybrid(h, tol=0.0, max_iters=j, **kw)[1]["var"])
         for j in (k - 1, k)]
    assert v[1] < v[0]
    return math.sqrt(v[0] * v[1])


@pytest.mark.parametrize("k", [3, 5, 8])
def test_hybrid_ice_calls_by_rounds(k):
    from hichap_master_tpu_torch.kernels.segment_marginal import \
        segment_marginal
    from hichap_master_tpu_torch.kernels.sparse_marginal import \
        block_sym_matvec
    from hichap_master_tpu_torch.ops.sparse_hybrid import ice_balance_hybrid

    calls = {"k2": 0, "k7": 0}

    def counted(f, key):
        def g(*a, **kw):
            calls[key] += 1
            return f(*a, **kw)
        return g

    h = _layout("cpu")
    kw = {"tile_matvec": counted(block_sym_matvec, "k2"),
          "scattered": counted(segment_marginal, "k7")}
    tol = _tol_stopping_at(h, k, **kw)
    calls.update(k2=0, k7=0)
    _, st = ice_balance_hybrid(h, tol=tol, **kw)
    assert int(st["iters"]) == k
    rounds = 4 * math.ceil(k / 4)
    assert calls == {"k2": rounds + 2, "k7": rounds + 1}


def test_launches_since_reads_every_wrapper(monkeypatch):
    import run

    name = "hichap_master_tpu_torch.kernels.fake_kernel"
    mod = types.ModuleType(name)

    def wrapper():
        wrapper.launches += 1

    def helper():
        pass

    def imported():
        pass

    wrapper.launches = imported.launches = 0
    wrapper.__module__ = helper.__module__ = name
    helper.launches = "not a count"
    # a wrapper imported from another module counts under that one only
    imported.__module__ = "hichap_master_tpu_torch.kernels.other_kernel"
    mod.wrapper, mod.helper, mod.imported = wrapper, helper, imported
    monkeypatch.setitem(sys.modules, name, mod)
    before = run.launch_counts()
    assert before["fake_kernel.wrapper"] == 0
    assert not {"fake_kernel.helper", "fake_kernel.imported"} & set(before)
    assert run.launches_since(before) == {}
    for _ in range(3):
        wrapper()
    assert run.launches_since(before) == {"fake_kernel.wrapper": 3}


@pytest.mark.chip
def test_counted_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import run

    from hichap_master_tpu_torch.ops.sparse_hybrid import ice_balance_hybrid

    h = _layout("cuda")
    for k in (5, 12):
        tol = _tol_stopping_at(h, k)
        before = run.launch_counts()
        _, st = ice_balance_hybrid(h, tol=tol)
        torch.cuda.synchronize()
        assert int(st["iters"]) == k
        rounds = 4 * math.ceil(k / 4)
        assert run.launches_since(before) == {K2: rounds + 2,
                                              K7: rounds + 1}

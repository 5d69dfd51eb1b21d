"""K10 (``kernels/intra_bin``) on the card: the kernel bit for bit against
its plain version, and ``_IntraAcc.add`` with nothing read back to the host.

These tests carry the ``chip`` marker and skip without a CUDA device.  The
file imports nothing of JAX, so the card runs it without the suite's
conftest (which does):

    python3 -m pytest --noconftest -m chip tests/test_torch_intra_bin.py
"""

import pytest
import torch

from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.io.bedio import TAG_R1
from hichap_master_tpu_torch.kernels.intra_bin import (intra_bin,
                                                       intra_bin_plain)
from hichap_master_tpu_torch.pipeline.matrix import _IntraAcc

# three size groups at 1 kb (1,300, 900, 400 and 300 bins)
SIZES = {"1": 1_300_000, "2": 900_000, "3": 400_000, "X": 300_000}
RES = 1_000


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _draw(n: int, dev, seed: int):
    """Pairs over the four chromosomes with trans pairs, chromosome indices
    past the table and below 0, positions below 0 and past each group's
    padded size, and tags."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    c1 = torch.randint(-1, 5, (n,), generator=g, device=dev)
    c2 = torch.where(torch.rand(n, generator=g, device=dev) < 0.7, c1,
                     torch.randint(0, 4, (n,), generator=g, device=dev))
    p1, p2 = (torch.randint(-3 * RES, 2_000 * RES, (n,), generator=g,
                            device=dev) for _ in range(2))
    tags = torch.randint(0, 3, (n,), generator=g, device=dev,
                         dtype=torch.int8)
    return c1, p1, c2, p2, tags


@pytest.mark.chip
@pytest.mark.parametrize("single_side", [False, True])
def test_intra_bin_matches_plain_on_the_card(single_side):
    dev = _card()
    acc = _IntraAcc(Genome(SIZES), RES, dev, single_side=single_side)
    want = torch.zeros_like(acc.flat)
    for seed, n in ((1, 1 << 20), (2, 0), (3, 12_345)):
        c1, p1, c2, p2, tags = _draw(n, dev, seed)
        r1 = (tags == TAG_R1) if single_side else None
        intra_bin(acc.flat, c1, p1, c2, p2, acc._base, acc._npad, RES, r1)
        intra_bin_plain(want, c1, p1, c2, p2, acc._base, acc._npad, RES, r1)
    torch.cuda.synchronize()
    assert torch.equal(acc.flat, want)
    assert want.sum() > 0


@pytest.mark.chip
@pytest.mark.parametrize("single_side", [False, True])
def test_intra_add_reads_nothing_back(single_side):
    """``_IntraAcc.add`` under ``set_sync_debug_mode("error")``: any
    synchronising call (a count read back, a boolean-mask gather) raises;
    the result is the CPU accumulator's."""
    dev = _card()
    cpu = torch.device("cpu")
    acc = _IntraAcc(Genome(SIZES), RES, dev, single_side=single_side)
    ref = _IntraAcc(Genome(SIZES), RES, cpu, single_side=single_side)
    cols = _draw(1 << 18, dev, 7)
    acc.add(*cols[:4], tags=cols[4])    # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            acc.add(*cols[:4], tags=cols[4])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(4):
        ref.add(*(t.cpu() for t in cols[:4]), tags=cols[4].cpu())
    assert torch.equal(acc.flat.cpu(), ref.flat)

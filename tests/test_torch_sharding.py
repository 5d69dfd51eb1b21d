"""The sharded functions of the port (hichap_master_tpu_torch.parallel) on 2
and 4 gloo ranks, against the JAX package's sharded functions on the suite's
8-device CPU mesh (tests/conftest.py; make_mesh(2) and make_mesh(4)) and
against the port's single-process functions.

The ranks are processes started by spawn (testing/sharding_ranks.py: gloo,
a file:// rendezvous in the test's temporary directory, one spawn per world
size for every function); they compute on the CPU, so the kernels run
through their plain versions.  The inputs are small and uneven: 5
chromosomes, 10 TAD sequences, and tile and pixel counts that neither world
size divides.  The JAX functions need shards that divide evenly, so they
get the same inputs padded with items that add nothing to what is
compared: repeated chromosomes, zero tiles (pad_blocks), sequences of
length 0, invalid candidate pixels, zero rows and columns.

Tolerances, those of hichap_master_tpu/testing/sharding_check.py:
two-step rtol 2e-5, atol 1e-6, gap masks equal; dense, sparse and hybrid
ICE rtol 1e-4 with equal NaN sets (hybrid also equal iteration counts);
sparse and dense genome-wide correction rtol 5e-4, atol 1e-6; loop
escalation `resolved` equal, backgrounds rtol 1e-6; compartment PC within
1e-3 up to sign; TAD EM equal iterations, log-likelihood rtol 1e-4,
parameters rtol 2e-3, atol 1e-5.  The DI of the training step (a t
statistic of the corrected matrices, which carry the two-step's 2e-5)
within rtol 1e-3, atol 1e-4.  Every rank returns the same global arrays:
rank results equal rank 0's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu import parallel as JP
from hichap_master_tpu.models.compartment import _compartment_fused
from hichap_master_tpu.ops import hmm as JH
from hichap_master_tpu.ops import sparse as JS
from hichap_master_tpu.ops import sparse_hybrid as JHY
from hichap_master_tpu.testing.oracles import synthetic_contact_matrix
from hichap_master_tpu_torch import parallel as P
from hichap_master_tpu_torch.kernels.escalation import escalation_batch
from hichap_master_tpu_torch.models.compartment import compartment_fused
from hichap_master_tpu_torch.models.tads import init_parameters
from hichap_master_tpu_torch.ops import hmm as PH
from hichap_master_tpu_torch.ops import sparse as PS
from hichap_master_tpu_torch.ops import sparse_hybrid as PHY
from hichap_master_tpu_torch.ops.balance import ice_balance
from hichap_master_tpu_torch.ops.correct import (genomewide_correction,
                                                 two_step_correction_batch)
from hichap_master_tpu_torch.ops.di import directionality_index, tad_gap_mask
from hichap_master_tpu_torch.ops.loops_packed import pack_margins
from hichap_master_tpu_torch.testing.sharding_ranks import run_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
TWO_STEP = dict(rtol=2e-5, atol=1e-6)
ICE_RTOL = 1e-4
GW = dict(rtol=5e-4, atol=1e-6)
DI = dict(rtol=1e-3, atol=1e-4)
EM_PARAMS = dict(rtol=2e-3, atol=1e-5)


def _inputs():
    """Every function's global inputs, seeds 11-17 (one a section)."""
    rng = np.random.default_rng(11)
    d = {}
    # two-step: 5 chromosomes of different sizes in a 128 padding
    C, N = 5, 128
    ns = np.array([100, 90, 120, 80, 110], np.int32)
    TM = np.zeros((C, N, N), np.float32)
    for i in range(C):
        TM[i, :ns[i], :ns[i]] = synthetic_contact_matrix(
            rng, ns[i], gap_frac=0.05, scale=80.0)
    d["two_step"] = (TM, (TM * 0.31).astype(np.float32),
                     (TM * 0.29).astype(np.float32), ns)
    # the genome-wide matrix: 200 bins in a 250 padding (no world size
    # divides it), asymmetric for the correction
    S, n2 = 250, 200
    G = np.zeros((S, S), np.float32)
    G[:n2, :n2] = synthetic_contact_matrix(rng, n2, gap_frac=0.0, scale=60.0)
    H = (G * rng.uniform(0.5, 1.5, G.shape)).astype(np.float32)
    alpha = np.ones(S, np.float32)
    alpha[:n2] = rng.uniform(0.4, 1.0, n2)
    d["ice"] = (G, n2)
    d["genomewide"] = (H, alpha, S)
    # the training step: the two-step batch and a 256-bin genome-wide matrix
    G2 = np.zeros((256, 256), np.float32)
    G2[:S, :S] = G
    a2 = np.ones(256, np.float32)
    a2[:S] = alpha
    d["train_step"] = (*d["two_step"], G2, a2, 256)
    # block-sparse: 64-bin tiles
    rng = np.random.default_rng(12)
    n3 = 600
    i3 = np.arange(n3)
    d3 = np.abs(np.subtract.outer(i3, i3))
    Msp = (rng.poisson(40.0 / (d3 + 1.0)) * (d3 < 96)).astype(np.float32)
    Msp = np.triu(Msp)
    Msp = Msp + np.triu(Msp, 1).T
    d["Msp"] = Msp
    Hasym = (Msp * rng.uniform(0.5, 1.5, Msp.shape)).astype(np.float32)
    ri, ci = np.nonzero(Hasym)
    d["asym_coo"] = (ri, ci, Hasym[ri, ci], n3)
    af = np.ones(((n3 + 63) // 64) * 64, np.float32)
    af[:n3] = rng.uniform(0.4, 1.0, n3)
    d["af"] = af
    # hybrid: a band plus scattered pixels
    rng = np.random.default_rng(13)
    n_h = 700
    i_h = np.arange(n_h)
    d_h = np.abs(np.subtract.outer(i_h, i_h))
    Mh = (rng.poisson(30.0 / (d_h + 1.0)) * (d_h < 80)).astype(np.float32)
    sc_r = rng.integers(0, n_h, 4020)
    sc_c = rng.integers(0, n_h, 4020)
    Mh[np.minimum(sc_r, sc_c), np.maximum(sc_r, sc_c)] += rng.poisson(
        2.0, 4020).astype(np.float32) + 1.0
    rh, ch = np.nonzero(np.triu(Mh))
    d["hybrid_coo"] = (rh, ch, Mh[rh, ch], n_h)
    # TAD EM: 10 sequences of 40-68 steps
    rng = np.random.default_rng(14)
    seqs = [(np.sin(np.linspace(0, 6, 40 + 7 * (i % 5))) * (2.0 + (i % 3))
             + rng.normal(0, 0.3, 40 + 7 * (i % 5))) for i in range(10)]
    X, L = PH._pad_sequences(seqs)
    m = init_parameters(3)
    d["tads_em"] = (X, L.astype(np.int64), m.A, m.pi, m.means, m.varis,
                    m.weights, m.A <= 0, m.pi <= 0)
    # loop escalation: 5 chromosomes of packed bands
    rng = np.random.default_rng(15)
    ww, maxww, pw = 3, 6, 1
    e_lo, _, x_pad = pack_margins(maxww)
    Cs, B, Xp, P2 = 5, 32, 128, 64
    E = B + 2 * e_lo
    Dr = rng.poisson(2.0, (Cs, E, Xp)).astype(np.float32)
    d["esc_args"] = (ww, maxww, pw, e_lo, x_pad)
    d["loop_escalation"] = (
        Dr, (Dr * 0.7).astype(np.float32), (Dr * 0.5 + 0.1).astype(np.float32),
        rng.integers(ww, B - 1, (Cs, P2)).astype(np.int32),
        rng.integers(0, Xp - 2 * x_pad - B, (Cs, P2)).astype(np.int32),
        rng.random((Cs, P2)) < 0.9)
    # compartments: 5 chromosomes of 100 bins in a 128 padding
    rng = np.random.default_rng(16)
    Cc, Nc, nc = 5, 128, 100
    Mb = np.zeros((Cc, Nc, Nc), np.float32)
    for i in range(Cc):
        Mb[i, :nc, :nc] = synthetic_contact_matrix(rng, nc, gap_frac=0.05,
                                                   scale=60.0)
    gapb = np.zeros((Cc, Nc), bool)
    gapb[:, nc:] = True
    ngb = np.zeros((Cc, Nc), np.int32)
    for i in range(Cc):
        ngb[i, :nc] = np.arange(nc)
    d["compartment"] = (Mb, gapb, np.full(Cc, nc, np.int32), ngb,
                        np.full(Cc, nc, np.int32))
    d["q0"] = np.array(jax.random.normal(jax.random.PRNGKey(0), (Nc, 7),
                                         jnp.float32))
    return d


IN = _inputs()
BM = PS.blocks_from_dense(IN["Msp"], T=64)
AB = PS.asym_blocks_from_coo(*IN["asym_coo"], T=64)
HYB = PHY.hybrid_from_coo(*(torch.from_numpy(np.asarray(a)) for a in
                            IN["hybrid_coo"][:3]), IN["hybrid_coo"][3],
                          T=64, min_tile_occ=64)


def _layout(world):
    return P.shard_hybrid_layout(HYB, world)


def _jobs(world):
    bm_h, scc, scv, lb, snz = _layout(world)
    return [
        ("shard_chrom_batch", "shard_chrom_batch", (), {},
         (IN["two_step"][0],)),
        ("two_step", "sharded_two_step", (), {}, IN["two_step"]),
        ("ice", "sharded_ice_balance", (), {}, IN["ice"]),
        ("genomewide", "sharded_genomewide_correction", (), {},
         IN["genomewide"]),
        ("train_step", "analysis_train_step", (), {}, IN["train_step"]),
        ("sparse_ice", "sharded_sparse_ice", (BM.R, BM.T),
         {"max_iters": 50}, (BM.tiles, BM.brow, BM.bcol, BM.n)),
        ("sparse_genomewide", "sharded_sparse_genomewide", (AB.R, AB.T), {},
         (AB.U, AB.L, AB.brow, AB.bcol, IN["af"])),
        ("hybrid_ice", "sharded_hybrid_ice", (bm_h.R, bm_h.T),
         {"max_iters": 30, "tol": 1e-6},
         (bm_h.tiles, bm_h.brow, bm_h.bcol, scc, scv, lb, snz, HYB.n)),
        ("tads_em", "sharded_tads_em", (), {"tol": 1e-6, "max_iters": 10},
         IN["tads_em"]),
        ("loop_escalation", "sharded_loop_escalation", IN["esc_args"], {},
         IN["loop_escalation"]),
        ("compartment", "sharded_compartment", (), {"q0": IN["q0"]},
         IN["compartment"]),
    ]


_RUNS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: each rank's record}, one spawn per world size."""

    def get(world):
        if world not in _RUNS:
            _RUNS[world] = run_ranks(
                _jobs(world), world,
                str(tmp_path_factory.mktemp(f"ranks{world}")), timeout=300)
        return _RUNS[world]

    return get


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same_on_every_rank(recs, name):
    ref = _flat(recs[0]["results"][name])
    for rec in recs[1:]:
        got = _flat(rec["results"][name])
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat(e)]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    return [x]


def _pad_rep(a, mult):
    """Repeat the last item until the first axis is a multiple of
    ``mult`` (JAX's shards must divide evenly)."""
    a = np.asarray(a)
    k = (-a.shape[0]) % mult
    return np.concatenate([a, np.repeat(a[-1:], k, 0)]) if k else a


def _weights_close(got, want, rtol=ICE_RTOL):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=rtol)


def _jx(a):
    return jnp.asarray(np.asarray(a))


# ---------------------------------------------------------- the checks
def check_make_mesh(recs, world, jm):
    assert recs[0]["shape"] == dict(jm.shape)


def check_shard_chrom_batch(recs, world, jm):
    TM = IN["two_step"][0]
    parts = [_np(r["results"]["shard_chrom_batch"]) for r in recs]
    assert sum(p.shape[0] for p in parts) == TM.shape[0]
    np.testing.assert_array_equal(np.concatenate(parts), TM)


def check_two_step(recs, world, jm):
    got = recs[0]["results"]["two_step"]
    TM, MM, PM, ns = IN["two_step"]
    a = jm.shape["chrom"]
    want = JP.sharded_two_step(jm)(*(_jx(_pad_rep(x, a))
                                     for x in (TM, MM, PM, ns)))
    single = two_step_correction_batch(_t(TM), _t(MM), _t(PM), _t(ns))
    C = TM.shape[0]
    for k in (0, 1):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k])[:C],
                                   **TWO_STEP)
        np.testing.assert_allclose(_np(got[k]), _np(single[k]), **TWO_STEP)
    for k in (2, 3):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k])[:C])
        np.testing.assert_array_equal(_np(got[k]), _np(single[k]))


def _pad_square(M, S):
    out = np.zeros((S, S), np.float32)
    out[:M.shape[0], :M.shape[1]] = M
    return out


def check_ice(recs, world, jm):
    w, st = recs[0]["results"]["ice"]
    G, n = IN["ice"]
    wj, stj = JP.sharded_ice_balance(jm)(_jx(_pad_square(G, 256)),
                                         jnp.asarray(n))
    _weights_close(w, np.asarray(wj)[:G.shape[0]])
    ws, sts = ice_balance(_t(G), n, max_iters=50)
    _weights_close(w, ws)
    assert int(st["iters"]) == int(stj["iters"]) == int(sts["iters"])


def check_genomewide(recs, world, jm):
    got = _np(recs[0]["results"]["genomewide"])
    H, alpha, S = IN["genomewide"]
    a2 = np.ones(256, np.float32)
    a2[:S] = alpha
    want = JP.sharded_genomewide_correction(jm)(
        _jx(_pad_square(H, 256)), _jx(a2), jnp.asarray(256))
    np.testing.assert_allclose(got, np.asarray(want)[:S, :S], **GW)
    np.testing.assert_allclose(got, _np(genomewide_correction(_t(H),
                                                              _t(alpha))),
                               **GW)


def check_train_step(recs, world, jm):
    got = recs[0]["results"]["train_step"]
    TM, MM, PM, ns, G, alpha, total = IN["train_step"]
    a = jm.shape["chrom"]
    want = JP.analysis_train_step(jm)(
        *(_jx(_pad_rep(x, a)) for x in (TM, MM, PM, ns)), _jx(G), _jx(alpha),
        jnp.asarray(total))
    C = TM.shape[0]
    nor = two_step_correction_batch(_t(TM), _t(MM), _t(PM), _t(ns))
    for k in (0, 1):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k])[:C],
                                   **TWO_STEP)
        np.testing.assert_allclose(_np(got[k]), _np(nor[k]), **TWO_STEP)
    _weights_close(got[2], np.asarray(want[2]))
    _weights_close(got[2], ice_balance(_t(G), total, max_iters=20)[0])
    np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), **GW)
    np.testing.assert_allclose(
        _np(got[3]), _np(genomewide_correction(_t(G), _t(alpha))), **GW)
    n = _t(ns)
    di = directionality_index(nor[0], tad_gap_mask(nor[0], n, 4), n, 4)
    np.testing.assert_allclose(_np(got[4]), np.asarray(want[4])[:C], **DI)
    np.testing.assert_allclose(_np(got[4]), _np(di), **DI)


def check_sparse_ice(recs, world, jm):
    w, st = recs[0]["results"]["sparse_ice"]
    bm = JS.pad_blocks(JS.blocks_from_dense(IN["Msp"], T=64), world)
    wj, stj = JP.sharded_sparse_ice(jm, bm.R, bm.T, max_iters=50)(
        _jx(bm.tiles), _jx(bm.brow), _jx(bm.bcol), jnp.asarray(bm.n))
    n = BM.n
    assert BM.K % world  # the port's tile shards are uneven
    _weights_close(_np(w)[:n], np.asarray(wj)[:n])
    ws, sts = PS.ice_balance_blocks(BM, "cpu", max_iters=50)
    _weights_close(_np(w)[:n], ws)
    assert int(st["iters"]) == int(stj["iters"]) == int(sts["iters"])


def check_sparse_genomewide(recs, world, jm):
    got = recs[0]["results"]["sparse_genomewide"]
    ab = JS.asym_blocks_from_coo(*IN["asym_coo"], T=64)
    assert ab.K == AB.K and AB.K % world
    pad = [JS.pad_blocks(JS.BlockMatrix(tiles=t, brow=ab.brow, bcol=ab.bcol,
                                        n=ab.n, T=ab.T, R=ab.R), world)
           for t in (ab.U, ab.L)]
    want = JP.sharded_sparse_genomewide(jm, ab.R, ab.T)(
        _jx(pad[0].tiles), _jx(pad[1].tiles), _jx(pad[0].brow),
        _jx(pad[0].bcol), _jx(IN["af"]))

    def dense(tiles):
        return PS.blocks_to_dense(PS.BlockMatrix(
            tiles=_np(tiles)[:AB.K], brow=_np(AB.brow), bcol=_np(AB.bcol),
            n=AB.n, T=AB.T, R=AB.R))

    np.testing.assert_allclose(dense(got), dense(np.asarray(want)), **GW)
    single = PS.genomewide_correction_blocks(AB, IN["af"][:AB.n],
                                             device="cpu")
    np.testing.assert_allclose(dense(got), dense(single.tiles), **GW)


def check_shard_hybrid_layout(recs, world, jm):
    bm, scc, scv, lb, snz = _layout(world)
    hj = JHY.hybrid_from_coo(*IN["hybrid_coo"], T=64, min_tile_occ=64)
    bj, _, _, lbj, snzj = JP.shard_hybrid_layout(hj, world)
    np.testing.assert_array_equal(_np(bm.tiles), bj.tiles)
    np.testing.assert_array_equal(_np(bm.brow), bj.brow)
    np.testing.assert_array_equal(_np(bm.bcol), bj.bcol)
    np.testing.assert_array_equal(_np(snz), snzj)
    # the ranks' clamped segments of each row add up to the row, and the
    # pixels they cover, rank after rank, are the row-sorted pixels
    lb = _np(lb).astype(np.int64)
    per = scc.numel() // world
    assert (lb[:, -1].sum() == HYB.sc_cols.numel()
            == int(lbj[:, -1].sum()))
    np.testing.assert_array_equal((lb[:, 1:] - lb[:, :-1]).sum(0)[:HYB.n],
                                  _np(HYB.sc_nnz))
    np.testing.assert_array_equal(
        np.concatenate([_np(scc)[r * per:r * per + lb[r, -1]]
                        for r in range(world)]), _np(HYB.sc_cols))
    # uneven shards: the directed pixels come in pairs (the diagonal is
    # left out), so only world 4 leaves a short last range
    assert HYB.sc_cols.numel() % 4 == 2 and bm.K > HYB.bm.K


def check_hybrid_ice(recs, world, jm):
    w, st = recs[0]["results"]["hybrid_ice"]
    hj = JHY.hybrid_from_coo(*IN["hybrid_coo"], T=64, min_tile_occ=64)
    assert hj.sc_nnz.sum() > 0 and hj.bm.K > 1
    bj, scc, scv, lbj, snzj = JP.shard_hybrid_layout(hj, world)
    wj, stj = JP.sharded_hybrid_ice(jm, bj.R, bj.T, max_iters=30, tol=1e-6)(
        *(_jx(a) for a in (bj.tiles, bj.brow, bj.bcol, scc, scv, lbj,
                           snzj)), jnp.asarray(hj.n))
    n = HYB.n
    _weights_close(_np(w)[:n], np.asarray(wj)[:n])
    ws, sts = PHY.ice_balance_hybrid(HYB, max_iters=30, tol=1e-6)
    _weights_close(_np(w)[:n], ws)
    assert int(st["iters"]) == int(stj["iters"]) == int(sts["iters"])


def check_tads_em(recs, world, jm):
    it, params, ll = recs[0]["results"]["tads_em"]
    X, L, *rest = IN["tads_em"]
    k = (-X.shape[0]) % world
    Xj = np.concatenate([X, np.zeros((k, X.shape[1]))])
    Lj = np.concatenate([L, np.zeros(k, L.dtype)]).astype(np.int32)
    it_j, params_j, ll_j = JP.sharded_tads_em(jm, tol=1e-6, max_iters=10)(
        _jx(Xj), _jx(Lj), *(_jx(a) for a in rest))
    it_1, params_1, ll_1 = PH.baum_welch_device(
        _t(X), _t(L), *(_t(np.asarray(a)) for a in rest), 1e-6, 10)
    assert int(it) == int(it_j) == int(it_1)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-4)
    np.testing.assert_allclose(float(ll), float(ll_1), rtol=1e-4)
    for p, pj, p1 in zip(params, params_j, params_1):
        np.testing.assert_allclose(_np(p), np.asarray(pj), **EM_PARAMS)
        np.testing.assert_allclose(_np(p), _np(p1), **EM_PARAMS)


def check_loop_escalation(recs, world, jm):
    got = recs[0]["results"]["loop_escalation"]
    args = IN["loop_escalation"]
    C = args[0].shape[0]
    k = (-C) % world
    padded = [_pad_rep(a, world) for a in args[:5]]
    padded.append(np.concatenate([args[5], np.zeros((k,) + args[5].shape[1:],
                                                    bool)]))
    want = JP.sharded_loop_escalation(jm, *IN["esc_args"])(
        *(_jx(a) for a in padded))
    ww, maxww, pw, e_lo, x_pad = IN["esc_args"]
    single = escalation_batch(*(_t(a) for a in args), ww, maxww, pw,
                              args[0].shape[1] - 2 * e_lo, e_lo, x_pad)
    assert bool(_np(got[0]).any())
    for ref in (tuple(np.asarray(w)[:C] for w in want),
                tuple(_np(s) for s in single)):
        np.testing.assert_array_equal(_np(got[0]), ref[0])
        for j in range(1, 5):
            np.testing.assert_allclose(_np(got[j]), ref[j], rtol=1e-6)


def check_compartment(recs, world, jm):
    got = recs[0]["results"]["compartment"]
    Mb, gapb, nb, ngb, gb = IN["compartment"]
    fn = JP.sharded_compartment(jm)
    want = fn(*(_jx(_pad_rep(a, world)) for a in IN["compartment"]))
    single = compartment_fused(_t(Mb), _t(gapb), _t(nb), _t(ngb).long(),
                               _t(gb), 0, "subspace", True, _t(IN["q0"]))
    for ref in (np.asarray(want[3]), _np(single[3])):
        for i in range(Mb.shape[0]):
            g, r = _np(got[3])[i], ref[i]
            err = min(np.abs(g - r).max(), np.abs(g + r).max())
            assert err < 1e-3, f"chrom {i}: pc mismatch {err}"


CHECKS = {k[len("check_"):]: v for k, v in globals().items()
          if k.startswith("check_")}


@pytest.mark.parametrize("name", sorted(CHECKS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax_and_single_process(ranks, world, name):
    recs = ranks(world)
    if name in recs[0]["results"] and name != "shard_chrom_batch":
        _same_on_every_rank(recs, name)
    CHECKS[name](recs, world, JP.make_mesh(world))


def test_every_rank_runs_every_job(ranks):
    """Every rank ran every job and reports the launch counts of K2, K3,
    K4 and K7: 0 on the CPU, where the wrappers run the plain versions
    (the card's counts are chip_smoke.py's to check).  At world 4 the last
    rank holds 2 of the 5 chromosomes, 1 of the 10 sequences and 2 padding
    ones."""
    for world in WORLDS:
        recs = ranks(world)
        assert len(recs) == world
        for r in recs:
            assert set(r["walls"]) == {j[0] for j in _jobs(world)}
            assert all(v == 0 for v in r["launches"].values())


def test_shard_range_covers_every_item_once():
    for n in (0, 1, 5, 23, 64, 250):
        for world in (1, 2, 3, 4, 8):
            got = [P.shard_range(n, world, r) for r in range(world)]
            assert got[0][0] == 0 and got[-1][1] == n
            for (a, b), (c, _) in zip(got, got[1:]):
                assert b == c and a <= b
            assert max(b - a for a, b in got) == -(-n // world)


def test_asym_blocks_match_jax():
    """asym_blocks_from_coo and asym_blocks_to_dense against the JAX
    package's on the same directed COO (float32 sums of the same pixels:
    identical), and sparse_genomewide_correction against the JAX one (K2's
    plain version: rtol 5e-4, atol 1e-6, as sharding_check holds it)."""
    ab = JS.asym_blocks_from_coo(*IN["asym_coo"], T=64)
    np.testing.assert_array_equal(_np(AB.U), ab.U)
    np.testing.assert_array_equal(_np(AB.L), ab.L)
    np.testing.assert_array_equal(_np(AB.brow), ab.brow)
    np.testing.assert_array_equal(_np(AB.bcol), ab.bcol)
    assert (AB.n, AB.T, AB.R, AB.K) == (ab.n, ab.T, ab.R, ab.K)
    np.testing.assert_array_equal(PS.asym_blocks_to_dense(AB),
                                  JS.asym_blocks_to_dense(ab))
    ri, ci, v, n = IN["asym_coo"]
    dense = np.zeros((n, n), np.float32)
    dense[ri, ci] = v
    np.testing.assert_array_equal(PS.asym_blocks_to_dense(AB), dense)
    want = JS.genomewide_correction_blocks(ab, IN["af"][:n])
    got = PS.genomewide_correction_blocks(ab, IN["af"][:n], device="cpu")
    np.testing.assert_allclose(PS.blocks_to_dense(got),
                               JS.blocks_to_dense(want), **GW)
    tiles = PS.sparse_genomewide_correction(
        *(_t(a) for a in (ab.U, ab.L, ab.brow, ab.bcol, IN["af"])),
        R=ab.R, T=ab.T)
    np.testing.assert_allclose(_np(tiles), np.asarray(want.tiles), **GW)


def test_asym_blocks_empty_and_convert():
    """No pixel at all gives one empty tile at (0, 0), as in the JAX
    package; convert.asym_blocks carries a JAX AsymBlocks across."""
    from hichap_master_tpu_torch.convert import asym_blocks

    e = PS.asym_blocks_from_coo(np.zeros(0, int), np.zeros(0, int),
                                np.zeros(0), 10, T=8)
    ej = JS.asym_blocks_from_coo(np.zeros(0, int), np.zeros(0, int),
                                 np.zeros(0), 10, T=8)
    assert e.K == ej.K == 1
    np.testing.assert_array_equal(_np(e.U), ej.U)
    np.testing.assert_array_equal(_np(e.brow), ej.brow)
    ab = JS.asym_blocks_from_coo(*IN["asym_coo"], T=64)
    c = asym_blocks(ab, "cpu")
    assert c.U.dtype == torch.float32 and c.brow.dtype == torch.int32
    np.testing.assert_array_equal(c.L.numpy(), ab.L)


def test_baum_welch_matches_jax():
    """baum_welch (the JAX signature: the model and every iteration's
    log-likelihood) against the JAX one, float64 on both sides (x64):
    rtol 1e-8 on the parameters and 1e-10 on the log-likelihoods, as
    tests/test_torch_hmm.py holds baum_welch_fused; and its result is
    baum_welch_fused's."""
    from hichap_master_tpu.models.tads import init_parameters as jax_priors

    rng = np.random.default_rng(5)
    seqs = [rng.normal(0, 1.0, L) + np.repeat(rng.choice([3.0, 0, -3.0],
                                                         L // 6 + 1), 6)[:L]
            for L in (120, 80, 95, 33)]
    got, hist = PH.baum_welch(init_parameters(3), seqs, max_iters=60,
                              device="cpu")
    want, hist_j = JH.baum_welch(jax_priors(3), seqs, max_iters=60)
    assert len(hist) == len(hist_j)
    np.testing.assert_allclose(hist, hist_j, rtol=1e-10)
    for f in ("A", "pi", "means", "varis", "weights"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    fused, it, ll = PH.baum_welch_fused(init_parameters(3), seqs,
                                        max_iters=60, device="cpu")
    assert it == len(hist) and ll == hist[-1]
    for f in ("A", "pi", "means", "varis", "weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(fused, f))


def test_em_statistics_of_shards_add_up():
    """The E-step statistics of two shards, one padded with sequences of
    length 0, add up to those of the whole batch (rtol 1e-12: sums in
    another order), which is what sharded_tads_em sums across ranks."""
    X, L, *rest = IN["tads_em"]
    params = [_t(np.asarray(a, np.float64)) for a in rest[:5]]
    whole = PH._e_sums(_t(X), _t(L), *params)
    Xp = np.concatenate([X, np.zeros((3, X.shape[1]))])
    Lp = np.concatenate([L, np.zeros(3, L.dtype)])
    parts = [PH._e_sums(_t(Xp[s]), _t(Lp[s]), *params)
             for s in (slice(0, 6), slice(6, 13))]
    for k, v in whole.items():
        np.testing.assert_allclose(_np(parts[0][k] + parts[1][k]), _np(v),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


def test_k4_padding_rows_and_k7_shards_through_the_plain_versions():
    """The inputs of chip_smoke.py's K4 and K7 edge cases for the sharded
    path, through the plain versions: K4's rows of length 0 (a rank's
    padded batch) give exact zeros (gamma, xi, log c) and the other rows
    what the batch without them gives (rtol 1e-12); K5's wrapper refuses a
    row of length 0; K7 on a rank's shard with clamped bounds gives 0 on
    its empty rows and, on the rows it holds (one cut at both ends, one at
    its start), the float64 sum of their pixels in the range (rtol 1e-6:
    one rounding to float32)."""
    import chip_smoke
    from hichap_master_tpu_torch.kernels import hmm_scan
    from hichap_master_tpu_torch.kernels.segment_marginal import \
        segment_marginal

    cpu = torch.device("cpu")
    b, A, pi, L = dict(chip_smoke.fb_edge_cases(cpu))[chip_smoke.PADDING_CASE]
    assert int((L == 0).sum()) == 3
    assert chip_smoke.padding_adds_nothing(hmm_scan.forward_backward_plain,
                                           b, A, pi, L)
    real = L > 0
    full = hmm_scan.forward_backward(b, A, pi, L)
    alone = hmm_scan.forward_backward(b[real], A, pi, L[real])
    for f, a in zip(full, alone):
        np.testing.assert_allclose(_np(f[real]), _np(a), rtol=1e-12,
                                   atol=1e-300)
    assert chip_smoke.viterbi_refuses_padding(cpu)

    cases = [c for n, c in chip_smoke.k7_edge_cases(cpu)
             if n.startswith(chip_smoke.SHARD_CASE)]
    assert len(cases) == 2
    for cols, vals, lb, bvec in cases:
        assert int(lb[0]) == 0 and int(lb[-1]) == cols.numel()
        got = _np(segment_marginal(cols, vals, lb, bvec))
        prod = _np(vals).astype(np.float64) * _np(bvec).astype(
            np.float64)[_np(cols)]
        lbn = _np(lb).astype(np.int64)
        want = np.array([prod[s:e].sum() for s, e in zip(lbn[:-1], lbn[1:])])
        empty = lbn[1:] == lbn[:-1]
        assert empty.any() and (got[empty] == 0).all()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # the first case's range lies inside one row: cut at both ends
    lbn = _np(cases[0][2])
    held = np.flatnonzero(lbn[1:] > lbn[:-1])
    assert held.size == 1 and lbn[held[0] + 1] - lbn[held[0]] == 4_000

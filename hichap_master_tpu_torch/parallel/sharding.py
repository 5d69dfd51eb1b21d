"""Sharding of the numerical core over the ranks of a process group.

Counterpart of ``hichap_master_tpu/parallel/sharding.py``.  The JAX module
annotates shardings on its jitted functions and lets GSPMD insert the
collectives; here each rank is a process of ``torch.distributed`` with its
own ``device``.  A rank takes its contiguous shard of the global inputs,
runs the single-device code (and so the kernels) on it, and adds what the
math adds across shards with one collective, a sum ``all_reduce``.  A
gather is an ``all_reduce`` of a zero-filled full-size buffer, exact
because every entry comes from one rank and the others add zeros: gloo
reduces CUDA tensors but does not gather them, and NCCL cannot put two
ranks on one card, so several ranks on one card run gloo with nothing but
``all_reduce``.  Every sharded function returns, on every rank, the global
arrays that the JAX function returns.

The scaling axes are the JAX module's:

* the chromosome batch (two-step correction, loop escalation,
  compartments): each rank runs its chromosomes and nothing crosses
  ranks until the results are gathered;
* the rows of a dense genome-wide matrix (ICE, the genome-wide
  correction): a rank's rows give their part of the marginal and of the
  row and column sums;
* the tiles and scattered pixels of the block-sparse and hybrid layouts:
  a rank's K2 (and K7) gives a partial marginal of every row, summed every
  iteration;
* the sequences of the TAD EM: a rank's K4 gives partial sufficient
  statistics, summed in float64; the parameters stay replicated.

A shard is a range of ceil(n / world) items (``shard_range``); the last
ranks' ranges are short or empty, or padded with items that add nothing
(zero tiles at block (0, 0), sequences of length 0).  The JAX module's
``make_mesh`` factorisation is kept as ``Mesh.shape``, but every function
shards over the flat rank set: only the results are compared.
"""

from __future__ import annotations

import datetime
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.escalation import escalation_batch
from ..kernels.segment_marginal import carry_scratch, segment_marginal
from ..kernels.sparse_marginal import block_sym_matvec, sparse_marginal_order
from ..models.compartment import compartment_fused
from ..ops.correct import two_step_correction_batch
from ..ops.di import directionality_index, tad_gap_mask
from ..ops.hmm import baum_welch_device
from ..ops.pca import start_block
from ..ops.sparse import (BlockMatrix, _genomewide_tiles, ice_iterate,
                          ice_keep, zero_tile_diagonals)

# a collective that waits longer than this raises instead of stalling
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def init_ranks(backend: str, init_method: str, world_size: int, rank: int,
               timeout: datetime.timedelta = COLLECTIVE_TIMEOUT) -> None:
    """Join the default process group with an explicit address
    (``tcp://localhost:<port>`` or ``file://<path>``), world size, rank and
    collective timeout."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def shard_range(n: int, world: int, rank: int) -> Tuple[int, int]:
    """``[lo, hi)``: rank ``rank``'s contiguous shard of ``n`` items in
    shards of ceil(n / world), clipped at ``n`` (short or empty on the last
    ranks)."""
    per = -(-n // world)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


class Mesh:
    """A process group seen as the JAX module's (chrom, bins) mesh: its
    world size, this process's rank and device, and the ``a x b``
    factorisation of the world size (``a >= b``)."""

    def __init__(self, group, device, shape: Tuple[int, int],
                 axis_names: Tuple[str, str] = ("chrom", "bins")):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.shape = dict(zip(axis_names, shape))

    def shard(self, n: int) -> Tuple[int, int]:
        return shard_range(n, self.world, self.rank)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def gather(self, local, lo: int, shape, dtype) -> torch.Tensor:
        """The global ``shape`` tensor whose entries ``[lo, lo + len)``
        along the first axis are this rank's ``local`` (None: no entries);
        booleans travel as uint8."""
        wire = torch.uint8 if dtype == torch.bool else dtype
        buf = torch.zeros(shape, dtype=wire, device=self.device)
        if local is not None and local.shape[0]:
            buf[lo:lo + local.shape[0]] = local.to(wire)
        self.psum(buf)
        return buf.bool() if dtype == torch.bool else buf


def make_mesh(n_devices: int | None = None,
              axis_names: Tuple[str, str] = ("chrom", "bins"), *, device,
              group=None) -> Mesh:
    """The mesh of an initialised process group (``init_ranks``; ``group``
    None is the default group) with this rank's ``device`` (no default).
    ``n_devices``, when given, must be the group's size.  The shape factors
    the size as the JAX module does: ``a * b = n``, ``a >= b``, ``a`` as
    small as possible."""
    n = dist.get_world_size(group)
    if n_devices not in (None, n):
        raise ValueError(f"the process group has {n} ranks, not {n_devices}")
    b = int(np.floor(np.sqrt(n)))
    while n % b:
        b -= 1
    return Mesh(group, device, (n // b, b), axis_names)


def _local(x, lo: int, hi: int, device, dtype=None) -> torch.Tensor:
    """Items ``[lo, hi)`` of an array or tensor, on ``device``."""
    if isinstance(x, torch.Tensor):
        part = x[lo:hi]
    else:
        part = torch.from_numpy(np.ascontiguousarray(np.asarray(x)[lo:hi]))
    return part.to(device=device, dtype=dtype).contiguous()


def _whole(x, device, dtype=None) -> torch.Tensor:
    """A replicated input, on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)


def _dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


def shard_chrom_batch(batch, mesh: Mesh) -> torch.Tensor:
    """This rank's chromosomes of a ``[C, N, N]`` batch, on its device (the
    JAX module places the whole batch over the chrom axis; a rank here
    keeps its own shard)."""
    return _local(batch, *mesh.shard(batch.shape[0]), mesh.device)


def _tile_shard(mesh: Mesh, tiles, *coords):
    """The rank's ceil(K / world) tiles of each tile tensor in ``tiles``
    (a tuple) and of the block coordinates, padded with zero tiles at block
    (0, 0), which add nothing to a marginal.  Returns (tiles..., coords...,
    number of real tiles)."""
    K = tiles[0].shape[0]
    per = -(-K // mesh.world)
    lo, hi = mesh.shard(K)
    out = []
    for t in tiles:
        part = _local(t, lo, hi, mesh.device)
        pad = part.new_zeros((per - part.shape[0],) + tuple(part.shape[1:]))
        out.append(torch.cat([part, pad]).contiguous())
    for c in coords:
        part = _local(c, lo, hi, mesh.device, torch.int32)
        out.append(torch.cat([part, part.new_zeros(per - part.shape[0])]))
    return (*out, hi - lo)


# --------------------------------------------------- chromosome batches
def _two_step_local(mesh: Mesh, TM, MM, PM, n):
    """The two-step correction of the rank's chromosomes: ((nor_mm,
    nor_pm, gap_m, gap_p) or None, lo)."""
    lo, hi = mesh.shard(TM.shape[0])
    if hi == lo:
        return None, lo
    dev = mesh.device
    t, m, p = (_local(x, lo, hi, dev) for x in (TM, MM, PM))
    return two_step_correction_batch(t, m, p, _local(n, lo, hi, dev)), lo


def _gather_two_step(mesh: Mesh, local, lo: int, MM):
    C, N = MM.shape[0], MM.shape[-1]
    dt = _dtype(MM)
    return tuple(mesh.gather(None if local is None else local[k], lo, shape,
                             d)
                 for k, (shape, d) in enumerate(
                     (((C, N, N), dt), ((C, N, N), dt),
                      ((C, N), torch.bool), ((C, N), torch.bool))))


def sharded_two_step(mesh: Mesh):
    """Per-chromosome two-step correction with the batch sharded by
    chromosome.  Returns fn(TM, MM, PM, n) -> (nor_mm, nor_pm, gap_m,
    gap_p), as ``ops.correct.two_step_correction_batch``."""

    def fn(TM, MM, PM, n):
        local, lo = _two_step_local(mesh, TM, MM, PM, n)
        return _gather_two_step(mesh, local, lo, MM)

    return fn


def sharded_loop_escalation(mesh: Mesh, ww: int, maxww: int, pw: int,
                            e_lo: int, x_pad: int):
    """Map-space loop escalation with the packed-band batch sharded by
    chromosome: each rank runs K3 (``kernels.escalation.escalation_batch``)
    on its chromosomes.  Returns fn(D_raw, D_bal, D_exp, e_pix, x_pix,
    valid) -> (resolved, bS_K, bE_K, bS_Y, bE_Y) per pixel ``[C, P]``."""

    def fn(D_raw, D_bal, D_exp, e_pix, x_pix, valid):
        C, E, _ = D_raw.shape
        P = e_pix.shape[1]
        lo, hi = mesh.shard(C)
        local = None
        if hi > lo:
            args = [_local(a, lo, hi, mesh.device)
                    for a in (D_raw, D_bal, D_exp, e_pix, x_pix, valid)]
            local = escalation_batch(*args, ww, maxww, pw, E - 2 * e_lo,
                                     e_lo, x_pad)
        return tuple(
            mesh.gather(None if local is None else local[k], lo, (C, P),
                        torch.bool if k == 0 else torch.float32)
            for k in range(5))

    return fn


def sharded_compartment(mesh: Mesh, step: int = 0,
                        pca_method: str = "subspace", q0=None):
    """The fused compartment graph (``models.compartment.
    compartment_fused``: decay, O/E, correlation, PCA, signed PC) with the
    chromosome batch sharded.  ``q0`` is the subspace start block
    ``[N, 7]`` (default ``ops.pca.start_block`` on the rank's device).
    Returns fn(Mb, gapb, nb, ngb, gb) -> (oe, cor, pcs, pc): Mb ``[C, N,
    N]``, gapb ``[C, N]`` bool, nb and gb ``[C]``, ngb ``[C, N]`` the
    non-gap column indices padded with 0."""

    def fn(Mb, gapb, nb, ngb, gb):
        C, N = Mb.shape[0], Mb.shape[-1]
        dt = _dtype(Mb)
        lo, hi = mesh.shard(C)
        local = None
        if hi > lo:
            dev = mesh.device
            q = None
            if pca_method == "subspace":
                q = (start_block(N, 7, device=dev) if q0 is None
                     else _whole(q0, dev))
            local = compartment_fused(
                _local(Mb, lo, hi, dev), _local(gapb, lo, hi, dev, torch.bool),
                _local(nb, lo, hi, dev), _local(ngb, lo, hi, dev, torch.int64),
                _local(gb, lo, hi, dev), step, pca_method, True, q)
        shapes = ((C, N, N), (C, N, N), (C, 3, N), (C, N))
        return tuple(mesh.gather(None if local is None else local[k], lo, s,
                                 dt) for k, s in enumerate(shapes))

    return fn


# ------------------------------------------------ rows of a dense matrix
def _rows(mesh: Mesh, M, n: int, ignore_diags: int):
    """The rank's rows ``[lo, hi)`` of a padded symmetric ``[N, N]``
    matrix in float32, with the first ``ignore_diags`` diagonals and the
    rows and columns past ``n`` zeroed; returns (rows, lo)."""
    N = M.shape[-1]
    lo, hi = mesh.shard(N)
    Ml = _local(M, lo, hi, mesh.device, torch.float32)
    i = torch.arange(lo, hi, device=mesh.device)[:, None]
    j = torch.arange(N, device=mesh.device)[None, :]
    drop = (i >= n) | (j >= n)
    if ignore_diags > 0:
        drop = drop | ((i - j).abs() < ignore_diags)
    return Ml.masked_fill(drop, 0.0), lo


def sharded_ice_balance(mesh: Mesh, *, ignore_diags: int = 1,
                        mad_max: int = 5, min_nnz: int = 10,
                        min_count: int = 0, tol: float = 1e-5,
                        max_iters: int = 50):
    """Genome-wide ICE with the matrix's rows sharded: each iteration's
    marginal is the rank's rows times the bias vector (``torch.matmul``;
    the JAX ``ice_balance`` it mirrors is plain ``jnp``), gathered; the
    filters' nonzero counts and first marginal likewise.  Returns
    fn(M, n) -> (weights [N], stats), as ``ops.balance.ice_balance``."""

    def fn(M, n):
        N, n = M.shape[-1], int(n)
        Ml, lo = _rows(mesh, M, n, ignore_diags)
        valid = torch.arange(N, device=mesh.device) < n
        nnz = mesh.gather((Ml != 0).sum(-1).to(torch.float32), lo, (N,),
                          torch.float32)
        marg0 = mesh.gather(Ml.sum(-1), lo, (N,), torch.float32)
        keep = ice_keep(valid, marg0, nnz, mad_max=mad_max, min_nnz=min_nnz,
                        min_count=min_count)
        return ice_iterate(
            lambda b: mesh.gather(Ml @ b, lo, (N,), torch.float32), keep,
            tol=tol, max_iters=max_iters)

    return fn


def sharded_genomewide_correction(mesh: Mesh, vc_alpha: float = 2.0 / 3.0):
    """Genome-wide two-step correction (``ops.correct.
    genomewide_correction``) with the rows sharded: the rank scales its
    rows by 1/alpha, the scaled matrix is gathered (the fold reads its
    transpose), each rank folds and corrects its rows with the row and
    column sums and both totals summed across ranks, and the corrected rows
    are gathered.  Returns fn(H, alpha, total) -> the corrected ``[N, N]``
    matrix (``total`` is the JAX signature's and unused, as there)."""

    def fn(H, alpha, total=None):
        del total
        N = H.shape[-1]
        dt = _dtype(H)
        dev = mesh.device
        lo, hi = mesh.shard(N)
        Hl = _local(H, lo, hi, dev)
        a = _whole(alpha, dev, dt)
        s = mesh.gather(Hl / a[lo:hi, None], lo, (N, N), dt)
        # the rank's rows of the fold: s + s^T off the diagonal, s on it
        r = torch.arange(hi - lo, device=dev)
        sym = s[lo:hi] + s[:, lo:hi].transpose(0, 1)
        sym[r, lo + r] = s[lo + r, lo + r]
        s1 = mesh.gather(sym.sum(-1), lo, (N,), dt) ** vc_alpha
        s2 = mesh.psum(sym.sum(0)) ** vc_alpha
        s1 = torch.where(s1 == 0, torch.ones_like(s1), s1)
        s2 = torch.where(s2 == 0, torch.ones_like(s2), s2)
        cor = sym / (s1[lo:hi, None] * s2[None, :])
        raw = mesh.psum(Hl.sum())
        tot = mesh.psum(cor.sum())
        rf = raw / tot.clamp_min(torch.finfo(dt).tiny)
        return mesh.gather(rf * cor, lo, (N, N), dt)

    return fn


def analysis_train_step(mesh: Mesh):
    """The JAX module's "training step" over one mesh: the two-step
    correction of a chromosome batch (sharded by chromosome), 20 ICE
    iterations of the genome-wide matrix and its genome-wide correction
    (sharded by rows), then the directionality index of the corrected
    maternal batch on each rank's chromosomes (TAD gaps and DI with a
    4-bin window).  Returns fn(TM, MM, PM, n_bins, G, alpha, total) ->
    (nor_mm, nor_pm, weights, corrected_G, di)."""
    ice = sharded_ice_balance(mesh, max_iters=20)
    gw = sharded_genomewide_correction(mesh)

    def step(TM, MM, PM, n_bins, G, alpha, total):
        local, lo = _two_step_local(mesh, TM, MM, PM, n_bins)
        di = None
        if local is not None:
            nor_mm = local[0]
            n = _local(n_bins, lo, lo + nor_mm.shape[0], mesh.device)
            di = directionality_index(nor_mm, tad_gap_mask(nor_mm, n, 4), n,
                                      4)
        nor_mm, nor_pm, _, _ = _gather_two_step(mesh, local, lo, MM)
        C, N = nor_mm.shape[0], nor_mm.shape[-1]
        di = mesh.gather(di, lo, (C, N), nor_mm.dtype)
        w, _ = ice(G, total)
        return nor_mm, nor_pm, w, gw(G, alpha, total), di

    return step


# ------------------------------------------ block-sparse and hybrid tiles
def sharded_sparse_ice(mesh: Mesh, R: int, T: int, *, max_iters: int = 200,
                       tol: float = 1e-5, ignore_diags: int = 1,
                       mad_max: int = 5, min_nnz: int = 10,
                       min_count: int = 0):
    """Genome-wide ICE on the block-sparse layout (``ops.sparse.
    sparse_ice_balance``) with the tiles sharded: each rank runs K2 on its
    tiles (padded to ceil(K / world) with zero tiles) and the partial
    marginals are summed every iteration.  Returns fn(tiles, brow, bcol,
    n) -> (weights [R*T], stats)."""

    def fn(tiles, brow, bcol, n):
        t, br, bc, _ = _tile_shard(mesh, (tiles,), brow, bcol)
        t = zero_tile_diagonals(t.to(torch.float32), br, bc, ignore_diags)
        order = sparse_marginal_order(br, bc, R)

        def marginal(x, b):
            return mesh.psum(block_sym_matvec(x, br, bc, b, R=R, T=T,
                                              order=order))

        valid = torch.arange(R * T, device=mesh.device) < int(n)
        ones = valid.to(torch.float32)
        marg0 = marginal(t, ones) * ones
        nnz = marginal((t != 0).to(torch.float32), ones)
        keep = ice_keep(valid, marg0, nnz, mad_max=mad_max, min_nnz=min_nnz,
                        min_count=min_count)
        return ice_iterate(lambda b: marginal(t, b), keep, tol=tol,
                           max_iters=max_iters)

    return fn


def sharded_sparse_genomewide(mesh: Mesh, R: int, T: int,
                              vc_alpha: float = 2.0 / 3.0):
    """Genome-wide two-step correction on asymmetric block storage
    (``ops.sparse.sparse_genomewide_correction``) with the U/L tile pairs
    sharded: each rank corrects its pairs, the VC row sums (K2) and both
    totals are summed across ranks, and the corrected tiles are gathered.
    Returns fn(U, L, brow, bcol, alpha_full) -> tiles ``[K, T, T]``."""

    def fn(U, L, brow, bcol, alpha_full):
        K = U.shape[0]
        u, l_, br, bc, k = _tile_shard(mesh, (U, L), brow, bcol)
        cor = _genomewide_tiles(u, l_, br, bc,
                                _whole(alpha_full, mesh.device), R, T,
                                vc_alpha, mesh.psum)
        return mesh.gather(cor[:k], mesh.shard(K)[0], (K, T, T), cor.dtype)

    return fn


def shard_hybrid_layout(h, n_devices: int):
    """A ``ops.sparse_hybrid.HybridGW`` laid out for ``sharded_hybrid_ice``
    on ``n_devices`` ranks, on the device of its tensors: the tiles padded
    to a multiple of ``n_devices`` (zero tiles at block (0, 0)), the
    row-sorted scattered pixels padded with zeros to ``per * n_devices``
    (``per`` = ceil(P / n_devices)), and each rank's CLAMPED row bounds:
    the global bounds shifted by the start of its range of pixels and
    clipped to it, so that rows outside the range are empty and a row that
    crosses a range's edge gets a partial sum on each side.  Returns
    (BlockMatrix, sc_cols [Pd], sc_vals [Pd], lbounds [D, N+1],
    sc_nnz [N]) with N = R * T."""
    bm = h.bm
    D = n_devices
    tiles, brow, bcol = (torch.as_tensor(a) for a in (bm.tiles, bm.brow,
                                                      bm.bcol))
    K = tiles.shape[0]
    pad = -(-K // D) * D - K
    dev = tiles.device
    bmp = BlockMatrix(
        tiles=torch.cat([tiles, tiles.new_zeros((pad,) + tiles.shape[1:])]),
        brow=torch.cat([brow.int(), brow.new_zeros(pad, dtype=torch.int32)]),
        bcol=torch.cat([bcol.int(), bcol.new_zeros(pad, dtype=torch.int32)]),
        n=bm.n, T=bm.T, R=bm.R)
    N = bm.R * bm.T
    cols = torch.as_tensor(h.sc_cols, device=dev)
    vals = torch.as_tensor(h.sc_vals, device=dev)
    bounds = torch.as_tensor(h.bounds, device=dev).long()
    P = int(bounds[-1])
    per = max(-(-P // D), 1)
    sc_cols = torch.zeros(per * D, dtype=torch.int32, device=dev)
    sc_vals = torch.zeros(per * D, dtype=vals.dtype, device=dev)
    sc_cols[:P] = cols[:P]
    sc_vals[:P] = vals[:P]
    gb = torch.full((N + 1,), P, dtype=torch.int64, device=dev)
    gb[:bounds.numel()] = bounds
    starts = torch.arange(D, device=dev)[:, None] * per
    lbounds = (gb[None, :] - starts).clamp(0, per).to(torch.int32)
    sc_nnz = torch.zeros(N, dtype=torch.float32, device=dev)
    nz = torch.as_tensor(h.sc_nnz, device=dev)
    sc_nnz[:nz.numel()] = nz
    return bmp, sc_cols, sc_vals, lbounds, sc_nnz


def sharded_hybrid_ice(mesh: Mesh, R: int, T: int, *, ignore_diags: int = 1,
                       mad_max: int = 5, min_nnz: int = 10,
                       min_count: int = 0, tol: float = 1e-5,
                       max_iters: int = 200):
    """The production genome-wide 10 kb weights path (``ops.sparse_hybrid.
    hybrid_ice_balance``) over the ranks: each rank runs K2 on its tiles
    and K7 on its contiguous range of scattered pixels against its clamped
    bounds, and the two partial marginals are summed in one collective.
    The filters and the loop are ``hybrid_ice_balance``'s.  Returns
    fn(tiles, brow, bcol, sc_cols, sc_vals, lbounds, sc_nnz, n) ->
    (weights [R*T], stats), with the arrays of ``shard_hybrid_layout``."""

    def fn(tiles, brow, bcol, sc_cols, sc_vals, lbounds, sc_nnz, n):
        D, r, dev = mesh.world, mesh.rank, mesh.device
        if lbounds.shape[0] != D or sc_cols.shape[0] % D:
            raise ValueError(f"a layout for {lbounds.shape[0]} ranks given "
                             f"to {D}; see shard_hybrid_layout")
        t, br, bc, _ = _tile_shard(mesh, (tiles,), brow, bcol)
        if not t.dtype.is_floating_point:
            t = t.to(torch.float32)   # uint16 storage, cast on the device
        t = zero_tile_diagonals(t, br, bc, ignore_diags)
        lb = _local(lbounds, r, r + 1, dev, torch.int32)[0]
        per = sc_cols.shape[0] // D
        n_px = int(lb[-1])    # the rank's pixels that belong to a row
        cols = _local(sc_cols, r * per, r * per + n_px, dev, torch.int32)
        vals = _local(sc_vals, r * per, r * per + n_px, dev)
        if vals.dtype not in (torch.float32, torch.uint16):
            vals = vals.to(torch.float32)
        kw = ({"scratch": carry_scratch(n_px, dev)} if dev.type == "cuda"
              else {})
        order = sparse_marginal_order(br, bc, R)

        def marginal(b):
            return mesh.psum(block_sym_matvec(t, br, bc, b, R=R, T=T,
                                              order=order)
                             + segment_marginal(cols, vals, lb, b, **kw))

        valid = torch.arange(R * T, device=dev) < int(n)
        ones = valid.to(torch.float32)
        marg0 = marginal(ones) * ones
        nnz = (mesh.psum(block_sym_matvec((t != 0).to(torch.float32), br, bc,
                                          ones, R=R, T=T, order=order))
               + _whole(sc_nnz, dev, torch.float32))
        keep = ice_keep(valid, marg0, nnz, mad_max=mad_max, min_nnz=min_nnz,
                        min_count=min_count)
        return ice_iterate(marginal, keep, tol=tol, max_iters=max_iters)

    return fn


# ------------------------------------------------------------ TAD EM
def sharded_tads_em(mesh: Mesh, tol: float = 1e-6, max_iters: int = 500):
    """GMM-HMM Baum-Welch (``ops.hmm.baum_welch_device``) with the padded
    DI-segment batch sharded by sequence: each rank runs K4 on its
    ceil(B / world) sequences (padded with sequences of length 0), the
    sufficient statistics and log-likelihood are summed in float64 in one
    collective an iteration, and the parameters stay replicated.  Returns
    fn(X [B, T], L [B], A0, pi0, means0, varis0, weights0, zero_A, zero_pi)
    -> (iterations, params, loglik)."""

    def fn(X, L, A0, pi0, means0, varis0, weights0, zero_A, zero_pi):
        B, T = X.shape
        dev = mesh.device
        lo, hi = mesh.shard(B)
        per = -(-B // mesh.world)
        Xl = torch.zeros(per, T, dtype=torch.float64, device=dev)
        Ll = torch.zeros(per, dtype=torch.int64, device=dev)
        Xl[:hi - lo] = _local(X, lo, hi, dev, torch.float64)
        Ll[:hi - lo] = _local(L, lo, hi, dev, torch.int64)
        params = [_whole(p, dev, torch.float64)
                  for p in (A0, pi0, means0, varis0, weights0)]

        def psum(st):
            keys = sorted(st)
            flat = mesh.psum(torch.cat([st[k].reshape(-1) for k in keys]))
            out, at = {}, 0
            for k in keys:
                out[k] = flat[at:at + st[k].numel()].reshape(st[k].shape)
                at += st[k].numel()
            return out

        return baum_welch_device(Xl, Ll, *params,
                                 _whole(zero_A, dev, torch.bool),
                                 _whole(zero_pi, dev, torch.bool), tol,
                                 max_iters, psum=psum, n_seqs=B)

    return fn

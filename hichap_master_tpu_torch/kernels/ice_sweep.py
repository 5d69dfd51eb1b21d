"""K1 — dense ICE iterations over a batch of padded matrices.

Replaces the Pallas kernel ``_sweep_kernel`` driven by ``pallas_ice_sweeps``
(``hichap_master_tpu/kernels/pallas_ice.py``).  The Pallas kernel runs a
fixed block of iterations per launch and leaves the convergence test to its
wrapper, which rounds the iteration count up to the block; here each matrix
carries its own ``active`` flag and counter on the device, so per-matrix
iteration counts equal ``ops.balance.ice_balance``'s exactly (the
``vmap(while_loop)`` semantics of ``ice_balance_batch``).

CUDA source: ``csrc/ice_sweep.cu``: one persistent cooperative launch runs
a whole block of iterations (biases in shared memory, one grid-wide barrier
per iteration, the stop decided on the device); see the note at its top.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build


@dataclasses.dataclass
class IceState:
    """Per-matrix iteration state, updated in place by ``ice_sweeps``.

    b      : [C, N] float32 bias (0 at filtered bins)
    iters  : [C] int32 iterations done
    var    : [C] float32 variance of the nonzero marginals (inf before 1st)
    scale  : [C] float32 mean of the nonzero marginals
    active : [C] int32, 1 while var >= tol and iters < max_iters
    """

    b: torch.Tensor
    iters: torch.Tensor
    var: torch.Tensor
    scale: torch.Tensor
    active: torch.Tensor

    @classmethod
    def start(cls, b0: torch.Tensor, max_iters: int) -> "IceState":
        C = b0.shape[0]
        dev = b0.device
        return cls(
            b=b0.to(torch.float32).contiguous().clone(),
            iters=torch.zeros(C, dtype=torch.int32, device=dev),
            var=torch.full((C,), float("inf"), dtype=torch.float32,
                           device=dev),
            scale=torch.ones(C, dtype=torch.float32, device=dev),
            active=torch.full((C,), int(max_iters > 0), dtype=torch.int32,
                              device=dev))


def ice_sweeps_plain(M0: torch.Tensor, st: IceState, *, iters: int,
                     tol: float, max_iters: int) -> None:
    """Plain PyTorch version of K1: up to ``iters`` masked ICE iterations,
    stopping like the kernel once no matrix is active."""
    from ..ops.masked import masked_mean, masked_var

    Mf = M0.float() if M0.dtype == torch.bfloat16 else M0
    for _ in range(iters):
        if not bool(st.active.any()):
            break
        b = st.b
        x = b.bfloat16().float() if M0.dtype == torch.bfloat16 else b
        marg = torch.bmm(Mf, x.unsqueeze(-1)).squeeze(-1) * b
        nz = marg != 0
        mean = masked_mean(marg, nz)
        var = masked_var(marg, nz)
        margn = marg / torch.where(mean != 0, mean,
                                   torch.ones_like(mean)).unsqueeze(-1)
        margn = torch.where(margn == 0, torch.ones_like(margn), margn)
        act = st.active.bool()
        st.b.copy_(torch.where(act.unsqueeze(-1), b / margn, b))
        st.iters.add_(act.to(torch.int32))
        st.var.copy_(torch.where(act, var, st.var))
        st.scale.copy_(torch.where(act, mean, st.scale))
        st.active.copy_((act & (st.var >= tol)
                         & (st.iters < max_iters)).to(torch.int32))


def ice_sweeps(M0: torch.Tensor, st: IceState, *, iters: int, tol: float,
               max_iters: int) -> None:
    """Run up to ``iters`` ICE iterations on every still-active matrix.

    M0 : [C, N, N] float32 or bfloat16, ignored diagonals and dead rows
         already zeroed.  ``st`` is updated in place; nothing is read back
         to the host.  CPU tensors take the plain version; CUDA tensors go
         through the kernel or raise: one cooperative launch for the whole
         block of iterations, which ends early on the device when every
         matrix has stopped.  A batch whose biases do not fit one block's
         shared memory runs as several launches over slices of the batch
         (the matrices are independent).
    """
    C, N = st.b.shape
    if M0.dim() != 3 or tuple(M0.shape) != (C, N, N):
        raise ValueError(f"M0 must be [C, N, N] = [{C}, {N}, {N}], "
                         f"got {tuple(M0.shape)}")
    if M0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"M0 must be float32 or bfloat16, got {M0.dtype}")
    if M0.device.type == "cpu":
        ice_sweeps_plain(M0, st, iters=iters, tol=tol, max_iters=max_iters)
        return
    if M0.device.type != "cuda":
        raise RuntimeError(f"no ICE kernel for device {M0.device}")
    for name in ("b", "iters", "var", "scale", "active"):
        t = getattr(st, name)
        if t.device != M0.device or not t.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous on "
                             f"{M0.device}")
    if not M0.is_contiguous():
        raise ValueError("M0 must be contiguous")
    if (st.b.dtype != torch.float32 or st.var.dtype != torch.float32
            or st.scale.dtype != torch.float32
            or st.iters.dtype != torch.int32
            or st.active.dtype != torch.int32):
        raise TypeError("IceState dtypes must be float32/int32")
    if C == 0 or iters <= 0:
        return
    lib = _build.load()
    bf16 = int(M0.dtype == torch.bfloat16)
    with torch.cuda.device(M0.device):
        step = lib.ice_sweep_max_batch(N, bf16)
        if step < 0:
            _build.check(-step, "ice_sweep_max_batch")
        if step == 0:
            raise ValueError(f"N = {N}: the biases of one matrix do not fit "
                             "a block's shared memory")
        stream = _build.stream_ptr(M0.device)
        marg = torch.empty((2, min(step, C), N), dtype=torch.float32,
                           device=M0.device)
        for c0 in range(0, C, step):
            c1 = min(c0 + step, C)
            _build.check(lib.ice_sweep(
                M0[c0:c1].data_ptr(), st.b[c0:c1].data_ptr(), marg.data_ptr(),
                st.active[c0:c1].data_ptr(), st.iters[c0:c1].data_ptr(),
                st.var[c0:c1].data_ptr(), st.scale[c0:c1].data_ptr(),
                c1 - c0, N, bf16, float(tol), int(max_iters), int(iters),
                stream), "ice_sweep")
            ice_sweeps.launches += 1


ice_sweeps.launches = 0

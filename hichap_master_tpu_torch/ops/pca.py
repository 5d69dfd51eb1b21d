"""Top-k PCA for compartment calling.

Counterpart of ``hichap_master_tpu/ops/pca.py``: the components are the
leading eigenvectors of the column covariance of the row-centred input
(sklearn ``PCA(n_components=3).fit(Cor)`` in the reference,
StructureFind.py:338-341).  The default is blocked subspace iteration (k + 4
columns, 100 sweeps of one product and one QR, then a Ritz rotation); the
exact path is ``torch.linalg.eigh``.  Signs are unspecified; the selectors
orient the chosen component.

The JAX package starts the subspace from ``jax.random.normal(PRNGKey(0),
(N, k + 4))``.  Here the start block ``q0 [N, k + 4]`` is an argument, drawn
from a ``torch.Generator`` seeded 0 when it is None; the parity tests pass
the JAX package's own block.  Inputs are ``[N, N]`` with a scalar ``n`` or
``[C, N, N]`` with ``n [C]`` (one start block for the whole batch, as the
JAX package's ``vmap`` shares its key).
"""

from __future__ import annotations

import torch

from .masked import valid_row_mask


def _valid(X: torch.Tensor, n) -> torch.Tensor:
    n = torch.as_tensor(n, device=X.device)
    return valid_row_mask(n, X.shape[-2]).to(X.dtype)


def _covariance(X: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    cnt = valid.sum(-1)[..., None, None].clamp_min(1.0)
    v = valid[..., :, None]
    mu = (X * v).sum(-2, keepdim=True) / cnt
    Xc = (X - mu) * v
    return Xc.transpose(-1, -2) @ Xc


def _top(w: torch.Tensor, V: torch.Tensor, k: int):
    """The k largest eigenpairs (eigenvectors as columns of ``V``)."""
    order = torch.argsort(-w, dim=-1, stable=True)[..., :k]
    Vk = torch.gather(V, -1, order[..., None, :].expand(*V.shape[:-1], k))
    return Vk, torch.gather(w, -1, order)


def start_block(N: int, q: int, dtype=torch.float32, *, device,
                seed: int = 0) -> torch.Tensor:
    """A standard-normal ``[N, q]`` start block from a generator on
    ``device``, seeded."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(N, q, generator=g, dtype=dtype, device=device)


def pca_components_subspace(X: torch.Tensor, n, k: int = 3,
                            iters: int = 100, oversample: int = 4,
                            q0: torch.Tensor | None = None):
    """``([..., k, N] components, [..., k] eigenvalues)`` by subspace
    iteration from the start block ``q0 [N, k + oversample]``."""
    N = X.shape[-1]
    valid = _valid(X, n)
    C = _covariance(X, valid)
    q = k + oversample
    if q0 is None:
        q0 = start_block(N, q, X.dtype, device=X.device)
    if tuple(q0.shape) != (N, q):
        raise ValueError(f"q0 must be [{N}, {q}], got {tuple(q0.shape)}")
    Q = q0.to(device=X.device, dtype=X.dtype) * valid[..., :, None]
    for _ in range(iters):
        Q = torch.linalg.qr(C @ Q).Q
    B = Q.transpose(-1, -2) @ (C @ Q)
    w, V = torch.linalg.eigh(B)
    Vk, wk = _top(w, V, k)
    comps = (Q @ Vk).transpose(-1, -2)
    comps = comps / torch.linalg.norm(comps, dim=-1, keepdim=True)
    # rank(C) < k (fewer non-gap bins than components): QR fills the null
    # space with arbitrary directions that can reach padded rows
    return comps * valid[..., None, :], wk


def pca_components_eigh(X: torch.Tensor, n, k: int = 3):
    """Exact dense path: ``([..., k, N], [..., k])`` from ``eigh``."""
    w, V = torch.linalg.eigh(_covariance(X, _valid(X, n)))
    Vk, wk = _top(w, V, k)
    return Vk.transpose(-1, -2), wk


def pca_components(X: torch.Tensor, n, k: int = 3, method: str = "subspace",
                   **kw):
    if method == "eigh":
        return pca_components_eigh(X, n, k)
    if method != "subspace":
        raise ValueError(f"unknown PCA method {method!r}")
    return pca_components_subspace(X, n, k, **kw)

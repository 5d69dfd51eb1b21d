"""The comparison that decides ``correct``: the compared job's output
against ``reference``, worked out anew from the same drawn pairs.

Numbers compared (each against the cell's limit in
``workloads/<cell>.json``; a number a job kind does not have is left
out):

* ``tables``: entries of the integer tables (Traditional, UnImputated and
  Imputated before correction, whole-genome and local, every resolution)
  whose count differs from the reference's;
* ``vote``: the vote's queries, hits and single-side counts off the
  reference's, summed over resolutions;
* ``corrected``: the largest relative gap of a corrected matrix entry
  (whole-genome and local), infinite where one side has an entry and the
  other none, or where a gap flag of the local corrections differs;
* ``weights``: the largest relative gap of an ICE weight where both are
  finite, every resolution;
* ``weights_nan``: bins whose weight is NaN on one side only;
* ``jobs``: jobs (the warm one and the window's) whose digest, the NaN
  weights of each resolution and the vote's counts, differs from the
  reference's (``digest``).

The program's outputs are read here only to judge them.
"""

from __future__ import annotations

import math

import torch

from . import reference as ref

ORDER = ("tables", "vote", "corrected", "weights", "weights_nan", "jobs")


# ---------------------------------------------------- the program's tables
def gw_upper(M, S: int) -> tuple:
    """Upper-triangle (keys, values) of a program's genome-wide symmetric
    matrix: a dense [S, S] tensor, a sparse accumulator or a COO tuple."""
    if isinstance(M, tuple):
        r, c, v = M
    elif isinstance(M, torch.Tensor):
        r, c = torch.triu(M).nonzero(as_tuple=True)
        v = M[r, c]
    else:
        r, c, v = M.coo()
    return _sorted(r.long() * S + c.long(), v)


def gw_directed(M, S: int) -> tuple:
    if isinstance(M, torch.Tensor):
        r, c = M.nonzero(as_tuple=True)
        v = M[r, c]
    else:
        r, c, v = M.coo()
    return _sorted(r.long() * S + c.long(), v)


def local_table(mats: dict, labels: list, N: int, upper: bool) -> tuple:
    """(keys, values) of a program's per-chromosome matrices, keyed
    ``(index in labels * N + row) * N + col`` as ``reference`` keys them."""
    keys, vals = [], []
    for i, lab in enumerate(labels):
        M = mats[lab]
        r, c = (torch.triu(M) if upper else M).nonzero(as_tuple=True)
        keys.append(ref.local_keys(torch.full_like(r, i), r, c, N))
        vals.append(M[r, c])
    return _sorted(torch.cat(keys), torch.cat(vals))


def _sorted(keys, vals) -> tuple:
    order = torch.argsort(keys)
    return keys[order], vals[order]


# ------------------------------------------------------------- measures
def _aligned(a: tuple, b: tuple) -> tuple:
    """The values of two (keys, values) tables on the union of their keys,
    zero where a table has no entry (float64)."""
    u, inv = torch.unique(torch.cat([a[0], b[0]]), return_inverse=True)
    n = a[0].numel()
    pa = torch.zeros(u.numel(), dtype=torch.float64, device=u.device)
    pb = torch.zeros_like(pa)
    pa[inv[:n]] = a[1].to(torch.float64)
    pb[inv[n:]] = b[1].to(torch.float64)
    return pa, pb


def mismatch(a: tuple, b: tuple) -> int:
    """Entries whose values differ (a missing entry counts as 0)."""
    pa, pb = _aligned(a, b)
    return int((pa != pb).sum())


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p - r| / |r| over the entries, infinite where r is 0 and p is
    not (NaN anywhere counts as infinite)."""
    p, r = p.to(torch.float64), r.to(torch.float64)
    if p.numel() == 0:
        return 0.0
    g = torch.where(r != 0, (p - r).abs() / r.abs(),
                    torch.where(p != 0, math.inf, 0.0))
    g = torch.where(torch.isnan(g), math.inf, g)
    return float(g.max())


def weights_gap(p: torch.Tensor, r: torch.Tensor) -> tuple:
    """(relative gap where both are finite, bins NaN on one side only)."""
    p, r = p.to(torch.float64), r.to(torch.float64).to(p.device)
    if p.shape != r.shape:
        return math.inf, max(p.numel(), r.numel())
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    both = fp & fr
    return rel_gap(p[both], r[both]), int((fp != fr).sum())


# ---------------------------------------------------------------- views
# A view holds what is judged, in the reference's form: ``tables`` {name:
# (keys, counts)}, ``vote`` {name: count}, ``corrected`` {name: (keys,
# values) or a dense matrix}, ``gaps`` {name: bool [n]} and ``weights``
# {res: [bins]}.  The reference's view also carries what metrics count
# from it, never judged: ``trad`` (the Traditional whole-genome tables)
# and, for a haplotype job, ``vote_inputs`` (``reference.haplotype``).


def reference_view(job, prec: ref.Prec = ref.REFERENCE) -> dict:
    """The view of the reference in ``prec`` for ``job``'s pairs."""
    cfg, L = job.cfg, job.cfg["lengths"]
    pairs = job.pairs()
    if job.kind == "matrix_weights":
        res = job.traffic["res"]
        trad = ref.traditional(pairs, L, [res], [], prec)
        del pairs
        return {"weights": _w(ref.traditional_weights(
            trad, L, [res], [], prec)), "trad": trad["whole"]}
    if job.kind == "traditional_matrix":
        trad = ref.traditional(pairs, L, job.whole, job.local, prec)
        view = {"tables": {
            **{f"Tradition_Whole/{r}": trad["whole"][r] for r in job.whole},
            **{f"Tradition_Local/{r}": trad["local"][r] for r in job.local}}}
    else:
        hap = ref.haplotype(pairs, L, job.whole, job.local,
                            cfg["vote"], prec)
        view = {"tables": {f"{k}/{r}": hap[k][r] for k in TABLES
                           for r in (job.whole if k.endswith("Whole")
                                     else job.local)},
                "vote": {f"{k}/{r}": hap[k][r] for k in VOTE
                         for r in job.whole}}
        cor = ref.haplotype_corrected(hap, L, job.whole, job.local, prec)
        view["corrected"] = {f"whole/{r}": cor["whole"][r]
                             for r in job.whole}
        view["gaps"] = {}
        for r in job.local:
            for i, m in cor["local"][r].items():
                view["corrected"][f"local/{r}/{i}"] = m
                view["gaps"][f"{r}/{i}"] = cor["gaps"][r][i]
        view["vote_inputs"] = hap["vote_inputs"]
        trad = {"whole": hap["Tradition_Whole"],
                "local": hap["Tradition_Local"]}
    del pairs
    view["weights"] = _w(ref.traditional_weights(
        trad, L, job.whole, job.local, prec))
    view["trad"] = trad["whole"]
    return view


def program_view(job, out) -> dict:
    """The view of the program's output ``out`` of ``job``."""
    L = job.cfg["lengths"]
    labels = list(job.cfg["labels"])
    hap_labels = [h + c for h in "MP" for c in labels]
    dev = job.device
    view = {"weights": dict(job.weights(out))}
    if job.kind == "matrix_weights":
        return view
    if job.kind == "traditional_matrix":
        data = {"Tradition_Whole": out["whole"],
                "Tradition_Local": out["local"]}
    else:
        data = out["data"]
    view["tables"] = {}
    for k in TABLES:
        if k not in data:
            continue
        hap = not k.startswith("Tradition")
        for r, M in data[k].items():
            if k.endswith("Whole"):
                S = ref.Bins(L + L if hap else L, r, dev).S
                t = gw_directed(M, S) if k == "Imputated_Whole" else \
                    gw_upper(M, S)
            else:
                N = int(ref.Bins(L, r, dev).n.max())
                t = local_table(M, hap_labels if hap else labels, N,
                                upper=k != "Imputated_Local")
            view["tables"][f"{k}/{r}"] = t
    if job.kind == "traditional_matrix":
        return view
    st = data["stats"]
    view["vote"] = {f"{k}/{r}": int(st[k].get(r, 0)) for k in VOTE
                    for r in job.whole}
    view["corrected"] = {f"whole/{r}": gw_upper(
        out["imputated"]["whole"][r], ref.Bins(L + L, r, dev).S)
        for r in job.whole}
    view["gaps"] = {}
    for r in job.local:
        for i, lab in enumerate(hap_labels):
            m = out["imputated"]["local"][r][lab]
            view["corrected"][f"local/{r}/{i}"] = m
            g = torch.zeros(m.shape[0], dtype=torch.bool, device=m.device)
            g[torch.as_tensor(out["gaps"][str(r)][lab],
                              dtype=torch.long).to(m.device)] = True
            view["gaps"][f"{r}/{i}"] = g
    return view


TABLES = ("Tradition_Whole", "Tradition_Local", "UnImputated_Whole",
          "UnImputated_Local", "Imputated_Whole", "Imputated_Local")
VOTE = ("vote_queries", "vote_hits", "single_side")


def _w(weights: dict) -> dict:
    return {r: w for r, (w, _) in weights.items()}


def numbers(got: dict, want: dict) -> dict:
    """The numbers of ``ORDER`` for view ``got`` judged against ``want``
    (every name ``want`` has; one ``got`` lacks counts as wholly wrong)."""
    nums = {}
    if "tables" in want:
        nums["tables"] = sum(
            mismatch(got["tables"][k], t) if k in got.get("tables", {})
            else t[0].numel() for k, t in want["tables"].items())
    if "vote" in want:
        nums["vote"] = sum(abs(got.get("vote", {}).get(k, 0) - v)
                           for k, v in want["vote"].items())
    if "corrected" in want:
        gap = 0.0
        for k, v in want["corrected"].items():
            g = got.get("corrected", {}).get(k)
            if g is None:
                gap = math.inf
            elif isinstance(v, tuple):
                gap = max(gap, rel_gap(*_aligned(g, v)))
            else:
                gap = max(gap, rel_gap(g, v) if g.shape == v.shape
                          else math.inf)
        nums["corrected"] = gap
    if "gaps" in want:
        for k, v in want["gaps"].items():
            g = got.get("gaps", {}).get(k)
            if (g is None or g.shape != v.shape
                    or bool((g.to(v.device) != v).any())):
                nums["corrected"] = math.inf
    gap, nan = 0.0, 0
    for r, w in want["weights"].items():
        g, n = weights_gap(got["weights"][r], w)
        gap, nan = max(gap, g), nan + n
    nums["weights"], nums["weights_nan"] = gap, nan
    return nums


def digest(view: dict) -> dict:
    """What every job of the window is held to: the NaN weights of each
    resolution and the vote's counts."""
    d = {f"nan/{r}": int(torch.isnan(w).sum())
         for r, w in view["weights"].items()}
    d.update(view.get("vote", {}))
    return d


def compare(job, out) -> tuple:
    """The numbers for the program's output ``out`` against the reference
    (``jobs`` is 1 when the output's digest differs from the reference's),
    and the reference's view."""
    got = program_view(job, out)
    want = reference_view(job)
    nums = numbers(got, want)
    nums["jobs"] = int(digest(got) != digest(want))
    return nums, want


def control(job, prec: ref.Prec = ref.CONTROL) -> dict:
    """The numbers for the reference computed in ``prec`` put in the
    program's place."""
    got = reference_view(job, prec)
    want = reference_view(job)
    nums = numbers(got, want)
    nums["jobs"] = int(digest(got) != digest(want))
    return nums


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) in ``ORDER``; a number without a
    limit, or a limit without its number, is not correct."""
    rows = [(k, nums.get(k), limits.get(k)) for k in ORDER
            if k in nums or k in limits]
    ok = all(v is not None and lim is not None and v <= lim
             for _, v, lim in rows)
    return ok, rows

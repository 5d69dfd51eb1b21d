"""The jobs a window repeats, by the ``job`` a traffic file names.

A job runs one entry point of the port on inputs drawn once from the
seed: the port gets only the drawn pairs (and, for ``matrix_weights``,
the map the port built from them in set-up; the pairs are then dropped,
as a deployment that re-balances holds the map and not the pairs, and
drawn again from the seed for the reference once the window has
closed).  Each job kind also says
what of its output ``compare`` judges, and gives a digest of every job's
output that costs nothing worth timing (host counts and a NaN count per
resolution), which ``compare`` holds to the reference's.

Kinds:

* ``haplotype_matrix``: ``pipeline.matrix.haplotype_matrix_construction``
  on the five allelic classes of one replicate;
* ``traditional_matrix``: ``traditional_matrix_construction`` on the
  pooled valid pairs;
* ``matrix_weights``: ``matrix_weights`` of the pooled pairs' whole-genome
  map at one resolution, the map built by the port in set-up.
"""

from __future__ import annotations

import torch

from . import generator, reference

PREFIX = "GM12878_R1_"


def draw(cfg: dict, seed: int, device, pooled: bool) -> object:
    """The configuration's pairs from ``seed``: the allelic classes, or
    their pooled valid pairs.  The allelic draw is the one the
    configuration states (``tags``, ``homolog``; the generator's defaults
    where it states none); malformed values raise ``ValueError``."""
    classes = generator.allelic_pairs(
        cfg["lengths"], cfg["counts"], seed, device=device,
        law=cfg["contacts"], tags=cfg.get("tags"),
        homolog=cfg.get("homolog", "cis"))
    if not pooled:
        return classes
    out = generator.pooled(classes)
    del classes
    return out


class Job:
    """One cell's job: set up from the configuration, the traffic and the
    seed, then ``run()`` as often as the window allows.  A configuration
    with other ICE settings than the port's, or a malformed allelic draw,
    is refused with ``ValueError``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from hichap_master_tpu_torch.core import Genome

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.seed = seed
        self.kind = traffic["job"]
        if cfg.get("ice", reference.ICE) != reference.ICE:
            raise ValueError(f"the port balances with {reference.ICE} "
                             f"only; the configuration states {cfg['ice']}")
        if self.kind not in ("haplotype_matrix", "traditional_matrix",
                             "matrix_weights"):
            raise ValueError(f"unknown job {self.kind!r}")
        self.genome = Genome(dict(zip(cfg["labels"], cfg["lengths"])))
        if self.genome.labels != list(cfg["labels"]):
            raise ValueError("labels must be in the port's registry order")
        self.whole, self.local = list(cfg["whole_res"]), list(cfg["local_res"])
        self.inputs = draw(cfg, seed, device,
                           pooled=self.kind != "haplotype_matrix")
        self.M = None
        if self.kind == "matrix_weights":
            from hichap_master_tpu_torch.pipeline.matrix import \
                build_traditional

            res = traffic["res"]
            self.M = build_traditional(
                self.inputs, self.genome, [res], [], device=device,
                dense_max_bins=cfg["dense_max_bins"])[0][res]
            self.inputs = None

    # ------------------------------------------------------------ running
    def run(self, walls: dict | None = None):
        from hichap_master_tpu_torch.pipeline import matrix

        cfg = self.cfg
        if self.kind == "haplotype_matrix":
            out = matrix.haplotype_matrix_construction(
                {PREFIX: self.inputs}, self.genome, self.whole, self.local,
                **cfg["vote"], device=self.device,
                dense_max_bins=cfg["dense_max_bins"], walls=walls)[PREFIX]
        elif self.kind == "traditional_matrix":
            out = matrix.traditional_matrix_construction(
                {PREFIX: self.inputs}, self.genome, self.whole, self.local,
                device=self.device,
                dense_max_bins=cfg["dense_max_bins"])[PREFIX + "Multi"]
        else:
            res = self.traffic["res"]
            w, st = matrix.matrix_weights(
                self.M, self.genome, res, False,
                dense_max_bins=cfg["dense_max_bins"])
            out = {"weights": {res: w}, "ice": {res: st}}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def free_program_state(self) -> None:
        """Drop what the port built in set-up (the map of
        ``matrix_weights``)."""
        self.M = None

    def pairs(self) -> object:
        """The drawn pairs, for the reference: those the jobs ran on, or
        for ``matrix_weights`` the same drawn again from the seed."""
        if self.inputs is None:
            return draw(self.cfg, self.seed, self.device, pooled=True)
        return self.inputs

    # ------------------------------------------------------------ reading
    @staticmethod
    def weights(out) -> dict:
        return (out["tradition"] if "tradition" in out else out)["weights"]

    @staticmethod
    def ice(out) -> dict:
        return (out["tradition"] if "tradition" in out else out)["ice"]

    def iters(self, out) -> int:
        """ICE iterations of the job, summed over its resolutions."""
        return sum(sum(s["iters"]) for s in self.ice(out).values())

    def digest(self, out) -> dict:
        """``compare.digest`` of the output, from host counts and one NaN
        count a resolution."""
        d = {f"nan/{res}": int(torch.isnan(w).sum())
             for res, w in self.weights(out).items()}
        if self.kind == "haplotype_matrix":
            st = out["data"]["stats"]
            d.update({f"{k}/{r}": int(v) for k, per in st.items()
                      for r, v in per.items()})
        return d

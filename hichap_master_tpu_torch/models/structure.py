"""StructureFind: the reference's class API over the port's cooler-backed
drivers (counterpart of ``hichap_master_tpu/models/structure.py``).

Construct with (cooler_fil, Res, Allelic[, GapFile, Loop_ratio,
Loop_strength]) and a ``device``, then call ``run_Compartment``,
``run_TADs`` or ``run_Loops``.  The reference's defaults are kept: the
first two plot unless ``plot=False`` (matplotlib, as in the JAX package).
"""

from __future__ import annotations

from typing import Optional

from .compartment import run_compartment
from .loops import run_loops
from .tads import run_tads


class StructureFind:
    def __init__(self, cooler_fil: str, Res: int, Allelic,
                 GapFile: Optional[str] = None, Loop_ratio: float = 0.6,
                 Loop_strength: float = 16, *, device):
        # "file.cool" and "file.cool::res" alike: the drivers add the res
        self.cooler_fil = cooler_fil.split("::")[0]
        self.Res = Res
        self.Allelic = Allelic
        self.Gap_file = GapFile
        self.ratio = Loop_ratio
        self.LoopStrength = Loop_strength
        self.device = device

    def run_Compartment(self, OutPath: str, plot: bool = True, MS: str = "IF",
                        SA: bool = False, Tranditional_PC_file=None,
                        pca_method: str = "subspace", selector: str = "new",
                        q0=None):
        return run_compartment(
            self.cooler_fil, self.Res, self.Allelic, OutPath, sliding=SA,
            traditional_pc_file=Tranditional_PC_file, plot=plot,
            pca_method=pca_method, ms=MS, selector=selector,
            device=self.device, q0=q0)

    def run_TADs(self, OutPath: str, **kwargs):
        return run_tads(
            self.cooler_fil, self.Res, self.Allelic, OutPath,
            min_tad=kwargs.get("minTAD", 200_000),
            max_tad=kwargs.get("maxTAD", 4_000_000),
            state_num=kwargs.get("state_num", 3),
            window=kwargs.get("window", 600_000),
            test_type=kwargs.get("test_type", "ttest"),
            plot=kwargs.get("plot", True), device=self.device)

    def run_Loops(self, OutPath: str, plot: bool = False):
        return run_loops(
            self.cooler_fil, self.Res, self.Allelic, OutPath,
            gap_file=self.Gap_file, loop_ratio=self.ratio,
            loop_strength=self.LoopStrength, plot=plot, device=self.device)

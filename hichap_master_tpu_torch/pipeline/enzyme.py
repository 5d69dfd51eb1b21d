"""Restriction-enzyme handling: site lookup, custom syntax, junction
sequences.

A copy of ``hichap_master_tpu/pipeline/enzyme.py`` (host code with no
numpy; the port keeps its own copy so that it imports nothing of the JAX
package), with the same names: ``ENZYME_DB`` (80 palindromic enzymes),
``enzyme_handle`` (the built-in table, then the ``A-AGCTT`` syntax, then the
optional Biopython adapter) and ``junction_info``.

The reference resolves ANY enzyme name through Bio.Restriction and falls
back to a custom ``A-AGCTT`` syntax (HiCHap/fastqPlus.py:18-64).  Biopython
is not a baked-in dependency here, so resolution is three-tiered:

1. a built-in table of unambiguous-site enzymes storing
   ``(site, fst5, fst3)`` — the same values ``Bio.Restriction.<E>.site``
   and ``.charac[:2]`` provide (palindromic within-site cutters, the only
   geometry that yields a well-defined Hi-C ligation junction);
2. the custom ``A-AGCTT`` cut-mark syntax (one ``-`` at the cut);
3. an optional Biopython adapter: when ``Bio.Restriction`` is importable,
   any remaining name resolves through it with the same geometry guards
   (plain-ACGT site, within-site symmetric cut).

Junction construction (``GetJuncSeqInfo``) is reproduced exactly:

    jplus  = site[:fst3 or None] + site[fst5:]
    jminus = reverse-complement analog, reversed

with the palindromy flag deciding whether the minus junction needs its own
search pass.
"""

from __future__ import annotations

from typing import Tuple

# name -> (site, top-strand cut offset).  All palindromic within-site
# cutters, so Bio.Restriction's charac[:2] == (cut, -cut).  Sites and cut
# positions are the standard REBASE values for these widely used enzymes;
# ambiguous-code sites (N/R/Y/...) and outside-site (type IIS) cutters are
# deliberately absent — they have no well-defined single Hi-C junction and
# the reference's own junction builder would mangle them too.
_PALINDROMIC = {
    # 4-cutters (the Hi-C workhorses)
    "MboI": ("GATC", 0), "DpnII": ("GATC", 0), "Sau3AI": ("GATC", 0),
    "NdeII": ("GATC", 0), "DpnI": ("GATC", 2),
    "MluCI": ("AATT", 0), "Tsp509I": ("AATT", 0),
    "NlaIII": ("CATG", 4),
    "MseI": ("TTAA", 1), "Csp6I": ("GTAC", 1), "RsaI": ("GTAC", 2),
    "CviQI": ("GTAC", 1),
    "HaeIII": ("GGCC", 2), "AluI": ("AGCT", 2),
    "HpaII": ("CCGG", 1), "MspI": ("CCGG", 1),
    "TaqI": ("TCGA", 1), "BfaI": ("CTAG", 1),
    "HhaI": ("GCGC", 3), "HinP1I": ("GCGC", 1),
    # 6-cutters
    "HindIII": ("AAGCTT", 1), "EcoRI": ("GAATTC", 1),
    "BamHI": ("GGATCC", 1), "BglII": ("AGATCT", 1),
    "NcoI": ("CCATGG", 1), "NdeI": ("CATATG", 2),
    "NheI": ("GCTAGC", 1), "SpeI": ("ACTAGT", 1),
    "XbaI": ("TCTAGA", 1), "XhoI": ("CTCGAG", 1),
    "SalI": ("GTCGAC", 1), "PstI": ("CTGCAG", 5),
    "SphI": ("GCATGC", 5), "KpnI": ("GGTACC", 5),
    "SacI": ("GAGCTC", 5), "ApaI": ("GGGCCC", 5),
    "SmaI": ("CCCGGG", 3), "XmaI": ("CCCGGG", 1),
    "EcoRV": ("GATATC", 3), "HpaI": ("GTTAAC", 3),
    "DraI": ("TTTAAA", 3), "SspI": ("AATATT", 3),
    "ScaI": ("AGTACT", 3), "StuI": ("AGGCCT", 3),
    "PvuII": ("CAGCTG", 3), "NaeI": ("GCCGGC", 3),
    "NruI": ("TCGCGA", 3), "ClaI": ("ATCGAT", 2),
    "AgeI": ("ACCGGT", 1), "MluI": ("ACGCGT", 1),
    "AatII": ("GACGTC", 5), "AflII": ("CTTAAG", 1),
    "AvrII": ("CCTAGG", 1), "BspHI": ("TCATGA", 1),
    "BspEI": ("TCCGGA", 1), "EagI": ("CGGCCG", 1),
    "MfeI": ("CAATTG", 1), "MscI": ("TGGCCA", 3),
    "NsiI": ("ATGCAT", 5), "PciI": ("ACATGT", 1),
    "PvuI": ("CGATCG", 4), "SacII": ("CCGCGG", 4),
    "BsrGI": ("TGTACA", 1), "BstBI": ("TTCGAA", 2),
    "FspI": ("TGCGCA", 3), "SnaBI": ("TACGTA", 3),
    "ZraI": ("GACGTC", 3), "AseI": ("ATTAAT", 2),
    "PsiI": ("TTATAA", 3), "BclI": ("TGATCA", 1),
    "BspDI": ("ATCGAT", 2), "AfeI": ("AGCGCT", 3),
    # 8-cutters
    "NotI": ("GCGGCCGC", 2), "AscI": ("GGCGCGCC", 2),
    "PacI": ("TTAATTAA", 5), "SbfI": ("CCTGCAGG", 6),
    "FseI": ("GGCCGGCC", 6), "PmeI": ("GTTTAAAC", 4),
    "SwaI": ("ATTTAAAT", 4), "SrfI": ("GCCCGGGC", 4),
}

# name -> (site, fst5, fst3); fst5 = cut offset on the 5' strand from the
# site start, fst3 = cut offset from the site end (negative).
ENZYME_DB = {name: (site, cut, -cut)
             for name, (site, cut) in _PALINDROMIC.items()}

_LEGAL = set("A-GCT")
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _from_biopython(enzyme: str):
    """Resolve through Bio.Restriction when installed (reference parity,
    fastqPlus.py:18-42); None when biopython is absent or has no such
    enzyme.  Raises for enzymes whose geometry cannot form a single
    unambiguous Hi-C junction."""
    try:
        from Bio import Restriction as _R
    except Exception:
        return None
    enz = getattr(_R, enzyme, None)
    if enz is None:
        return None
    site = str(enz.site)
    fst5, fst3 = enz.charac[0], enz.charac[1]
    if (not site or set(site) - set("ACGT") or fst5 is None or fst3 is None
            or not (0 <= fst5 <= len(site)) or not (-len(site) <= fst3 <= 0)):
        raise ValueError(
            f"Enzyme {enzyme!r} has an ambiguous site or outside-site cut "
            f"(site={site!r}, cut=({fst5}, {fst3})) — no single Hi-C "
            "ligation junction exists; pick the explicit A-AGCTT syntax "
            "if you know the junction you want")
    return site, (fst5, fst3)


def enzyme_handle(enzyme: str) -> Tuple[str, Tuple[int, int]]:
    """Resolve an enzyme name or custom ``A-AGCTT`` spec → (site, cutsite)."""
    if enzyme in ENZYME_DB:
        site, fst5, fst3 = ENZYME_DB[enzyme]
        return site, (fst5, fst3)
    if "-" in enzyme:
        for ch in enzyme:
            if ch not in _LEGAL:
                raise ValueError(
                    f"Illegal character {ch!r} in enzyme {enzyme!r}")
        if enzyme.count("-") != 1:
            raise ValueError(
                f"Enzyme spec {enzyme!r} needs exactly ONE '-' cut mark "
                "(e.g. A-AGCTT)")
        site = "".join(enzyme.split("-"))
        cut = enzyme.index("-")
        return site, (cut, -cut)
    got = _from_biopython(enzyme)
    if got is not None:
        return got
    raise ValueError(
        f"Unknown enzyme {enzyme!r}: not in the built-in table "
        f"({len(ENZYME_DB)} common enzymes), Bio.Restriction is not "
        "installed to resolve the rest of REBASE, and the name carries no "
        "'-' cut mark — spell the site as e.g. A-AGCTT")


def junction_info(site: str, cutsite: Tuple[int, int]) -> Tuple[str, str, bool]:
    """(junction_plus, junction_minus, palindromic) — fastqPlus.py:45-64."""
    rev = "".join(_COMP[b] for b in site)
    if cutsite[-1]:
        jplus = site[: cutsite[-1]] + site[cutsite[0]:]
        jminus = rev[: cutsite[-1]] + rev[cutsite[0]:]
    else:
        jplus = site + site[cutsite[0]:]
        jminus = rev + rev[cutsite[0]:]
    jminus = jminus[::-1]
    return jplus, jminus, jplus == jminus

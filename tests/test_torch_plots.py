"""Port parity of the figures: ``run_compartment(plot=True)`` with ``ms``
IF, OE and Cor, ``run_tads(plot=True)``, ``plot_loops`` (traditional and
allelic) and ``run_loops(plot=True)``, and the command line's
``compartment --plot`` / ``tads --plot``, against the JAX package's on the
same cooler.  Figures are captured as ``tests/test_plot_content.py`` does
(every figure handed to ``PdfPages.savefig``) and compared element by
element: PDF names, pages, axes labels, limits and tick labels, heatmap
arrays, colour maps and colour limits, the filled tracks, the domain
boxes and the loop markers.

Tolerances: heatmaps drawn from the cooler (IF, the balanced TAD and loop
windows) and every box and marker are compared exactly; the O/E and
correlation heatmaps, their colour limits and the filled PC and DI tracks
within atol 1e-5, the float32 compartment and DI values' bar in
``tests/test_torch_compartment.py`` and ``tests/test_torch_tads.py``.
"""

import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu import cli as JCLI
from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader, write_cooler
from hichap_master_tpu.models import compartment as JC
from hichap_master_tpu.models import loops as JL
from hichap_master_tpu.models import tads as JT
from hichap_master_tpu_torch import cli as PCLI
from hichap_master_tpu_torch.models import compartment as PC
from hichap_master_tpu_torch.models import loops as PL
from hichap_master_tpu_torch.models import tads as PT
from hichap_master_tpu_torch.ops import pca as PCA

torch.set_num_threads(1)

RES = 40_000
ATOL = 1e-5


def jax_start(N, q):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (N, q),
                                      jnp.float32))


@pytest.fixture
def figs(monkeypatch):
    """Every figure handed to ``PdfPages.savefig`` (still written)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backends.backend_pdf import PdfPages

    got = []
    orig = PdfPages.savefig

    def spy(self, figure=None, **kw):
        got.append(figure)
        return orig(self, figure, **kw)

    monkeypatch.setattr(PdfPages, "savefig", spy)
    return got


@pytest.fixture(scope="module")
def cool(tmp_path_factory):
    """A traditional cooler: chromosome 1 at 4.8 Mb with 20-bin domains and
    A/B-like blocks, chromosome 2 shorter than one 4 Mb plot window."""
    rng = np.random.default_rng(20260816)
    g = Genome({"1": 4_800_000, "2": 2_000_000})
    mats = {}
    for c in g.labels:
        n = g.n_bins(c, RES)
        i = np.arange(n)
        d = np.abs(np.subtract.outer(i, i)) + 1.0
        lam = 60.0 / d ** 0.8
        same = np.equal.outer(i // 20, i // 20)
        ab = np.equal.outer((i // 15) % 2, (i // 15) % 2)
        M = rng.poisson(lam * np.where(same, 4.0, 1.0)
                        * np.where(ab, 1.5, 1.0)).astype(np.float32)
        mats[c] = np.triu(M) + np.triu(M, 1).T
    path = str(tmp_path_factory.mktemp("plots") / "p.cool")
    write_cooler(path, g, RES, mats)
    r = CoolerReader(path, RES)
    r.set_weights(np.ones(r.nbins))
    return path


def _fill_track(ax):
    """The filled track of an axes: per integer x, the max-|y| vertex of
    the fill_between polygons (the baseline gives 0)."""
    n = int(round(ax.get_xlim()[1]))
    ys = np.zeros(n)
    for coll in ax.collections:
        for path in coll.get_paths():
            for x, y in path.vertices:
                xi = int(round(x))
                if 0 <= xi < n and abs(y) > abs(ys[xi]):
                    ys[xi] = y
    return ys


def _same_axes(ap, aj, exact):
    assert ap.get_xlabel() == aj.get_xlabel()
    assert ap.get_ylabel() == aj.get_ylabel()
    np.testing.assert_allclose(ap.get_xlim(), aj.get_xlim())
    np.testing.assert_allclose(ap.get_ylim(), aj.get_ylim(), atol=ATOL)
    np.testing.assert_array_equal(ap.get_xticks(), aj.get_xticks())
    assert ([t.get_text() for t in ap.get_xticklabels()]
            == [t.get_text() for t in aj.get_xticklabels()])
    assert len(ap.images) == len(aj.images)
    for ip, ij in zip(ap.images, aj.images):
        a, b = np.asarray(ip.get_array()), np.asarray(ij.get_array())
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ip.get_clim(), ij.get_clim())
        else:
            np.testing.assert_allclose(a, b, atol=ATOL)
            np.testing.assert_allclose(ip.get_clim(), ij.get_clim(),
                                       atol=ATOL)
        lut = np.linspace(0, 1, 7)
        np.testing.assert_array_equal(ip.get_cmap()(lut), ij.get_cmap()(lut))
        assert ip.origin == ij.origin
    boxes_p = sorted((tuple(ln.get_xdata()), tuple(ln.get_ydata()))
                     for ln in ap.lines)
    boxes_j = sorted((tuple(ln.get_xdata()), tuple(ln.get_ydata()))
                     for ln in aj.lines)
    assert boxes_p == boxes_j
    scat = [c for c in ap.collections if len(c.get_offsets()) and
            c.get_facecolors().size == 0]
    scat_j = [c for c in aj.collections if len(c.get_offsets()) and
              c.get_facecolors().size == 0]
    assert len(scat) == len(scat_j)
    for cp, cj in zip(scat, scat_j):
        np.testing.assert_array_equal(cp.get_offsets(), cj.get_offsets())
        np.testing.assert_array_equal(cp.get_edgecolors(), cj.get_edgecolors())
    if not ap.images and ap.collections and not scat:
        # a filled track: the same values, the same colours
        np.testing.assert_allclose(_fill_track(ap), _fill_track(aj),
                                   atol=ATOL)
        assert ([tuple(c.get_facecolor()[0]) for c in ap.collections]
                == [tuple(c.get_facecolor()[0]) for c in aj.collections])


def _same_figs(got, want, exact=True):
    assert len(got) == len(want) > 0
    for fp, fj in zip(got, want):
        np.testing.assert_array_equal(fp.get_size_inches(),
                                      fj.get_size_inches())
        assert len(fp.axes) == len(fj.axes)
        for ap, aj in zip(fp.axes, fj.axes):
            _same_axes(ap, aj, exact)


def _pdfs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pdf"))


def _twice(figs, run_j, run_p):
    """Run the JAX package, then the port; returns (port figures, JAX
    figures)."""
    run_j()
    want = list(figs)
    figs.clear()
    run_p()
    return list(figs), want


@pytest.mark.parametrize("ms", ["IF", "OE", "Cor"])
def test_compartment_plot_matches_jax(cool, tmp_path, figs, ms):
    dj, dp = str(tmp_path / "j" / "PC"), str(tmp_path / "p" / "PC")
    got, want = _twice(
        figs, lambda: JC.run_compartment(cool, RES, False, dj, plot=True,
                                         ms=ms),
        lambda: PC.run_compartment(cool, RES, False, dp, plot=True, ms=ms,
                                   device="cpu", q0=jax_start))
    assert _pdfs(dp) == _pdfs(dj) == [f"PC_Compartment_{ms}_40K.pdf"]
    assert len(got) == 2  # a page a chromosome
    _same_figs(got, want, exact=ms == "IF")


def test_tads_plot_matches_jax(cool, tmp_path, figs):
    dj, dp = str(tmp_path / "j" / "TAD"), str(tmp_path / "p" / "TAD")
    got, want = _twice(
        figs, lambda: JT.run_tads(cool, RES, False, dj, plot=True),
        lambda: PT.run_tads(cool, RES, False, dp, plot=True, device="cpu"))
    assert _pdfs(dp) == _pdfs(dj) == ["TAD_TADs_Plot_40K.pdf"]
    # chromosome 1 in one 4 Mb window, chromosome 2 whole on one page
    assert len(got) == 2
    assert any(len(f.axes[1].lines) for f in got), "no domain drawn"
    _same_figs(got, want)


@pytest.mark.parametrize("allelic", [False, "Maternal"])
def test_plot_loops_matches_jax(cool, tmp_path, figs, allelic):
    loops = [("1", 20 * RES, 60 * RES), ("1", 10 * RES, 80 * RES),
             ("1", 100 * RES, 104 * RES), ("2", 5 * RES, 9 * RES)]
    cluster = tmp_path / "Cluster_Loops.txt"
    cluster.write_text("chromLabel\tloc_1\tloc_2\n" + "".join(
        f"{c}\t{a}\t{b}\n" for c, a, b in loops))
    reader = CoolerReader(cool, RES)
    prefix = "M" if allelic else ""
    mats = {}
    for c in reader.chromnames:
        M = reader.matrix(c, balance=False)
        iu, ju = np.nonzero(np.triu(M))
        mats[prefix + c] = PL._sym_csr(iu, ju, M[iu, ju], M.shape[0])
    got, want = _twice(
        figs, lambda: JL.plot_loops(str(tmp_path / "j.pdf"), cool, RES,
                                    allelic, str(cluster), mats),
        lambda: PL.plot_loops(str(tmp_path / "p.pdf"), cool, RES, allelic,
                              str(cluster), mats))
    assert len(got) == 1  # one full window of chromosome 1 holds loops
    _same_figs(got, want)
    # the two loops of the window, one marker each
    assert [len(c.get_offsets()) for c in got[0].axes[0].collections] == \
        [1, 1]


def test_run_loops_plot_matches_jax(cool, tmp_path, figs):
    dj, dp = str(tmp_path / "j" / "LP"), str(tmp_path / "p" / "LP")
    got, want = _twice(
        figs, lambda: JL.run_loops(cool, RES, False, dj, plot=True),
        lambda: PL.run_loops(cool, RES, False, dp, plot=True, device="cpu"))
    assert _pdfs(dp) == _pdfs(dj) == ["LP_Loops_Plot_40K.pdf"]
    assert len(got) == len(want)
    if want:
        _same_figs(got, want)


def _cli(cli, argv):
    root = logging.getLogger()
    before, hook = list(root.handlers), sys.excepthook
    try:
        return cli.run(argv)
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()
        sys.excepthook = hook


def _jax_block(N, q, dtype=torch.float32, *, device, seed=0):
    return torch.from_numpy(jax_start(N, q)).to(device, dtype)


@pytest.mark.parametrize("command", ["compartment", "tads"])
def test_cli_plots_match_jax(cool, tmp_path, figs, monkeypatch, command):
    monkeypatch.setattr(PCA, "start_block", _jax_block)
    argv = [command, "-c", cool, "-R", str(RES), "--plot"]
    got, want = _twice(
        figs,
        lambda: _cli(JCLI, argv + ["-o", str(tmp_path / "j" / "X"), "-w",
                                   str(tmp_path / "wj")]),
        lambda: _cli(PCLI, argv + ["-o", str(tmp_path / "p" / "X"), "-w",
                                   str(tmp_path / "wp"), "--device", "cpu"]))
    assert (_pdfs(tmp_path / "p" / "X") == _pdfs(tmp_path / "j" / "X")
            == [{"compartment": "X_Compartment_IF_40K.pdf",
                 "tads": "X_TADs_Plot_40K.pdf"}[command]])
    _same_figs(got, want)

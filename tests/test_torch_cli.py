"""The port's command line (hichap_master_tpu_torch.cli) against the JAX
package's (hichap_master_tpu.cli).

Parser: every sub-command of the JAX CLI takes the same option strings,
defaults, choices, types, ``nargs`` and ``required`` flags, with
``--device`` the only extra; ``--device cuda`` with no card visible
fails.

``rebuildG`` (diploid and ``-N``), ``rebuildF``, ``GlobalMapping`` and
``ReMapping`` (``--fake-aligner``, SAM and ``--bam-format``, PBS mode
falling back to WS) and ``Rescue`` through both CLIs on the same inputs
(the JAX package's ``diploid_dataset``, its chunks, its FakeAligner
``Global_bams`` and its rescue FASTQs): the output directories byte for
byte (``Snps.npz`` as loaded arrays, FASTQ chunks and BAM files
decompressed), completion markers included, and ``-r`` skipping each stage
in both once its marker is there.

``bamProcess`` through both CLIs on copies of one workspace of alignment
files (``testing.synthetic.alignment_chunks``), allelic and ``-N``: the
output directories byte for byte, completion marker included, and ``-r``
skipping the stage in both once the marker is there.

``filtering`` through both CLIs on copies of one workspace of chunk beds
(``testing.synthetic.record_beds``, its duplicates under their first
line's name and differing only in column 4, which no stage reads): the
valid beds line for line but column 4, the allelic beds as multisets of
lines (tests/test_torch_filtering.py holds the functions to the full
rule).

Chains on the CPU (``--device cpu``): the same beds (an allelic draw with
planted loops and domains, ``testing.synthetic.allelic_pairs``, and its
pairs as one 15-column valid bed for ``-N``) through ``matrix`` of both
CLIs, then the analysis commands.  The coolers compare as in
tests/test_torch_matrix_files.py: integer datasets identical, corrected
counts to 1e-5 relative (float32 sums in another order), ICE weights to
1e-4 relative with identical NaN sets, the gap npz identical.  Those float32
differences move calls, so each analysis command of both CLIs reads the
port's coolers, and their output files compare as in
tests/test_torch_run_drivers.py: compartment values to atol 1e-6 on
unit-norm tracks, DI values to rtol 1e-6, boundary-test statistics to rtol
1e-12, every other line identical.  The CLI cannot pass the subspace start
block, so the port's default start block (``ops.pca.start_block``) is
monkeypatched to the JAX package's ``jax.random.normal(PRNGKey(0), (N,
q))``, as the driver tests pass it.  The allelic tracks compare to atol
1e-5: the draw plants no A/B compartments, so the haplotype matrices' leading
eigengap is small and float32 subspace sweeps in another order part by up
to ~3e-6 (the traditional tracks, on more pairs, stay within 1e-6)."""

import json
import logging
import os
import shutil
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu import cli as JCLI
from hichap_master_tpu_torch import cli as PCLI
from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.ops import pca as PCA
from hichap_master_tpu_torch.testing.parity import assert_close_nan
from hichap_master_tpu_torch.testing.synthetic import (alignment_chunks,
                                                       allelic_pairs,
                                                       planted_loops,
                                                       record_beds,
                                                       write_allelic_beds,
                                                       write_valid_bed)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = ("rebuildG", "rebuildF", "GlobalMapping", "Rescue", "ReMapping",
            "bamProcess", "filtering", "matrix", "compartment", "tads",
            "loops", "specificity")
LENGTHS = {"1": 12_010_000, "2": 10_030_000}
COUNTS = {"Bi_Allelic": 60_000, "M_M": 30_000, "P_P": 30_000,
          "M_P": 3_000, "P_M": 3_000}
RES_W, RES_L = 500_000, 40_000
PREFIX = "Cell_R1_"


# ------------------------------------------------------------------ parser
def _subparsers(parser):
    action = next(a for a in parser._actions
                  if a.__class__.__name__ == "_SubParsersAction")
    return action.choices


def _options(parser):
    return {tuple(a.option_strings) or (a.dest,): (
        a.dest, a.default, a.choices, a.type, a.nargs, a.required,
        a.__class__.__name__) for a in parser._actions}


@pytest.mark.parametrize("command", COMMANDS)
def test_parser_matches_the_jax_cli(command):
    got = _options(_subparsers(PCLI.build_parser())[command])
    want = _options(_subparsers(JCLI.build_parser())[command])
    extra = {k: v for k, v in got.items() if k not in want}
    assert list(extra) == [("--device",)]
    assert extra[("--device",)][:2] == ("device", "cuda")
    assert {k: v for k, v in got.items() if k in want} == want


def test_every_jax_command_is_ported():
    """Every sub-command of the JAX CLI is ported, the mapping ones too: no
    command is left out."""
    got = set(_subparsers(PCLI.build_parser()))
    want = set(_subparsers(JCLI.build_parser()))
    assert got == set(COMMANDS)
    assert want - got == set()


def test_a_cuda_device_that_is_not_visible_fails(tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        PCLI.run(["tads", "-w", str(tmp_path / "ws"), "-c", "x.cool",
                  "-R", "40000", "-o", str(tmp_path / "o")])
    assert e.value.code == 2
    assert "--device cuda" in capsys.readouterr().err
    assert not (tmp_path / "ws").exists()


def _masked_lines(path):
    """The lines of ``path`` with column 4 blanked."""
    out = []
    with open(path, "rb") as f:
        for ln in f.read().splitlines():
            cols = ln.split(b"\t")
            cols[4] = b""
            out.append(b"\t".join(cols))
    return out


@pytest.mark.parametrize("mode", ["allelic", "NonAllelic"])
def test_filtering_command_matches_the_jax_cli(tmp_path, mode):
    raw = tmp_path / "raw"
    record_beds(str(raw), "cell", [3_000_000, 2_000_000], ["1", "10"], 3000,
                3, seed=4, device="cpu")
    for hap in ("Maternal", "Paternal"):
        first = {}
        for name in sorted(os.listdir(raw)):
            if hap not in name:
                continue
            lines = (raw / name).read_bytes().splitlines(keepends=True)
            out = []
            for ln in lines:
                f = ln.split(b"\t")
                key = tuple(f[i] for i in (1, 2, 3, 8, 9, 10))
                if key in first:
                    f[0], f[4] = first[key], b"99"
                first.setdefault(key, f[0])
                out.append(b"\t".join(f))
            (raw / name).write_bytes(b"".join(out))
    if mode == "NonAllelic":      # one haplotype's chunk beds: a library
        for name in os.listdir(raw):
            if "Paternal" in name:
                os.remove(raw / name)
    argv = ["filtering"] + (["-N", "-uc"] if mode == "NonAllelic" else [])
    for side in ("j", "p"):
        shutil.copytree(raw, tmp_path / f"w{side}" / "UniqRawBed")
        args = argv + ["-w", str(tmp_path / f"w{side}")]
        cli = JCLI if side == "j" else PCLI
        assert _run(cli, args + ([] if side == "j" else ["--device", "cpu"])
                    ) == 0
    wj, wp = tmp_path / "wj", tmp_path / "wp"
    names = sorted(os.listdir(wp / "Filtered_Bed"))
    assert names == sorted(os.listdir(wj / "Filtered_Bed")) == (
        ["cell_Valid.bed"] if mode == "NonAllelic" else
        ["cell_Maternal_Valid.bed", "cell_Paternal_Valid.bed"])
    for name in names:
        got = _masked_lines(wp / "Filtered_Bed" / name)
        assert got and got == _masked_lines(wj / "Filtered_Bed" / name)
    assert sorted(os.listdir(wp / "UniqRawBed")) == sorted(
        os.listdir(wj / "UniqRawBed")) == (
        sorted(os.listdir(raw)) if mode == "NonAllelic" else [])
    m = _metrics(tmp_path, "filtering")
    if mode == "NonAllelic":
        assert not (wp / "Allelic_Bed").exists()
        assert {"filtering.total", "filtering.NonAllelic.sort"} <= set(m)
        return
    for k in ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M"):
        name = f"cell_Valid_{k}.bed"
        got = sorted(_lines(str(wp / "Allelic_Bed" / name)))
        assert got and got == sorted(_lines(str(wj / "Allelic_Bed" / name)))
    assert {"filtering.total", "filtering.Maternal.scan",
            "filtering.Paternal.write", "filtering.allelic.join",
            "filtering.allelic.assign"} <= set(m)


@pytest.mark.parametrize("mode", ["allelic", "NonAllelic"])
def test_bam_process_command_matches_the_jax_cli(tmp_path, mode):
    raw = tmp_path / "raw"
    truth = alignment_chunks(str(raw / "Global_bams"),
                             str(raw / "ReMap_bams"), "cell",
                             [3_000_000, 2_000_000], ["1", "10"], 1500, 2,
                             seed=6, device="cpu")
    argv = (["bamProcess", "-f", *truth["fragments"], "-s", truth["snps"]]
            if mode == "allelic" else
            ["bamProcess", "-N", "-f", truth["fragments"][0], "--rfo"])
    for side, cli in (("j", JCLI), ("p", PCLI)):
        shutil.copytree(raw, tmp_path / f"w{side}")
        args = argv + ["-w", str(tmp_path / f"w{side}")]
        assert _run(cli, args + (["--device", "cpu"] if side == "p" else [])
                    ) == 0
    wj, wp = tmp_path / "wj" / "UniqRawBed", tmp_path / "wp" / "UniqRawBed"
    names = sorted(os.listdir(wp))
    assert names == sorted(os.listdir(wj))
    assert ".hichap_stage_done" in names and len(names) == (
        5 if mode == "allelic" else 3)
    for name in names:
        assert (wp / name).read_bytes() == (wj / name).read_bytes(), name
    m = _metrics(tmp_path, "bamProcess")
    tags = ("Maternal", "Paternal") if mode == "allelic" else (
        "NonAllelic",)
    assert set(m) == {"bamProcess.total"} | {
        f"bamProcess.{t}.{s}" for t in tags
        for s in ("read", "sort", "resolve", "write")}
    # -r: the marker is there, so both CLIs skip the stage
    for side, cli in (("j", JCLI), ("p", PCLI)):
        w = tmp_path / f"w{side}"
        bed = sorted((w / "UniqRawBed").glob("*.bed"))[0]
        bed.unlink()
        args = argv + ["-w", str(w), "-r"]
        assert _run(cli, args + (["--device", "cpu"] if side == "p" else [])
                    ) == 0
        assert not bed.exists()


def _outputs(d):
    """The files under ``d``: bytes, FASTQ chunks decompressed, npz as
    arrays."""
    import gzip

    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            key = os.path.relpath(p, d)
            if f.endswith(".npz"):
                with np.load(p) as z:
                    out[key] = {k: (z[k].dtype.str, z[k].tolist())
                                for k in z.files}
            elif f.endswith((".gz", ".bam")):
                out[key] = gzip.open(p).read()
            else:
                out[key] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def front(tmp_path_factory):
    """The JAX package's diploid dataset, its chunks, its FakeAligner
    Global_bams and their rescue FASTQs."""
    from hichap_master_tpu.pipeline import chunking as JC
    from hichap_master_tpu.pipeline import genome_rebuild as JG
    from hichap_master_tpu.pipeline.mapping import FakeAligner, ws_mapping
    from hichap_master_tpu.pipeline.rescue import cutting_reads_to_remapping
    from hichap_master_tpu.testing.synthetic import diploid_dataset

    d = tmp_path_factory.mktemp("front")
    data = diploid_dataset(np.random.default_rng(8), str(d / "data"),
                           n_pairs=200, n_snps=40, read_len=40,
                           junction_frac=0.4)
    g = d / "genome"
    g.mkdir()
    out = JG.rebuild_genome(data["fasta"], JG.snps_integration(
        data["snps"], str(g)), "MboI", str(g))
    for mate, fq in ((1, data["fq1"]), (2, data["fq2"])):
        JC.split_reads(fq, str(d / "fq"), 80, mate)
    ws_mapping(str(d / "fq"), str(d / "Global_bams"),
               [out["Maternal"], out["Paternal"]], aligner=FakeAligner(),
               jobs=1)
    cutting_reads_to_remapping(str(d / "Global_bams"), str(d / "RescueFastq"),
                               "MboI")
    data["haplotypes"] = [out["Maternal"], out["Paternal"]]
    return d, data


def _front_both(tmp_path, argv, stage_dir, setup=None):
    """``argv`` through both CLIs in workspaces wj and wp (``setup(ws)``
    first), the stage directories compared, then ``-r`` skipping the stage
    in both once its marker is there."""
    for side, cli in (("j", JCLI), ("p", PCLI)):
        ws = tmp_path / f"w{side}"
        ws.mkdir()
        if setup:
            setup(ws)
        args = argv + ["-w", str(ws)]
        assert _run(cli, args + (["--device", "cpu"] if side == "p" else [])
                    ) == 0
    want = _outputs(tmp_path / "wj" / stage_dir)
    got = _outputs(tmp_path / "wp" / stage_dir)
    assert sorted(got) == sorted(want)
    assert ".hichap_stage_done" in got
    for k in want:
        assert got[k] == want[k], k
    for side, cli in (("j", JCLI), ("p", PCLI)):
        ws = tmp_path / f"w{side}"
        victim = sorted(p for p in (ws / stage_dir).rglob("*")
                        if p.is_file() and p.name != ".hichap_stage_done")[0]
        victim.unlink()
        args = argv + ["-w", str(ws), "-r"]
        assert _run(cli, args + (["--device", "cpu"] if side == "p" else [])
                    ) == 0
        assert not victim.exists()
    return want


@pytest.mark.parametrize("mode", ["allelic", "NonAllelic"])
def test_rebuild_genome_command_matches_the_jax_cli(front, tmp_path, mode):
    d, data = front
    argv = ["rebuildG", "-g", data["fasta"], "-e", "HindIII"] + (
        ["-S", data["snps"]] if mode == "allelic" else ["-N"])
    got = _front_both(tmp_path, argv, "genome")
    names = {"genomeSize", "HindIII_genome_fragments.txt"} if (
        mode == "NonAllelic") else {
        "genomeSize", "Snps.npz", "Maternal/Maternal.fa",
        "Paternal/Paternal.fa", "Maternal/HindIII_Maternal_fragments.txt",
        "Paternal/HindIII_Paternal_fragments.txt"}
    assert set(got) - {".hichap_stage_done"} == names
    m = _metrics(tmp_path, "rebuildG")
    steps = {"read", "sites", "write", "index"} | (
        {"snps", "substitute"} if mode == "allelic" else set())
    assert set(m) == {"rebuildG.total"} | {f"rebuildG.{k}" for k in steps}


def test_rebuild_genome_needs_snps_unless_nonallelic(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _run(PCLI, ["rebuildG", "-g", "x.fa", "-w", str(tmp_path / "ws"),
                    "--device", "cpu"])
    assert e.value.code == 2
    assert "needs -S/--Snp unless -N" in capsys.readouterr().err


def test_rebuild_fastq_command_matches_the_jax_cli(front, tmp_path):
    d, data = front
    got = _front_both(tmp_path, ["rebuildF", "-1", data["fq1"], "-2",
                                 data["fq2"], "-c", "70"], "fastqchunks")
    assert len(got) == 2 * 3 + 1
    m = _metrics(tmp_path, "rebuildF")
    assert set(m) == {"rebuildF.total", "rebuildF.mate1", "rebuildF.mate2"}


@pytest.mark.parametrize("case", ["mate1_bad", "mate2_bad", "stale"])
def test_rebuild_fastq_leaves_the_jax_cli_directory(front, tmp_path, case):
    """Mate 1 is split before mate 2 in the JAX CLI: where mate 1 is no
    FASTQ, mate 2 leaves nothing; where mate 2 is none, mate 1's chunks and
    mate 2's partial ones stay.  Stale chunks of an earlier run are
    removed or kept as the JAX CLI removes or keeps them."""
    import gzip

    d, data = front
    good = [(gzip.open if data[k].endswith(".gz") else open)(
        data[k], "rb").read() for k in ("fq1", "fq2")]
    fqs = []
    for mate, text in ((1, good[0]), (2, good[1])):
        if case == f"mate{mate}_bad":
            lines = text.split(b"\n")
            text = b"\n".join(lines[:4 * 150] + [b"no_at"] + lines[4 * 150:])
        fqs.append(tmp_path / f"cell_{mate}.fastq")
        fqs[-1].write_bytes(text)
    argv = ["rebuildF", "-1", str(fqs[0]), "-2", str(fqs[1]), "-c", "100"]
    for side, cli in (("j", JCLI), ("p", PCLI)):
        ws = tmp_path / f"w{side}"
        (ws / "fastqchunks").mkdir(parents=True)
        for name in ("cell_chunk2_1", "cell_chunk2_2", "cell_chunk5_2"):
            with gzip.open(ws / "fastqchunks" / f"{name}.fastq.gz",
                           "wb") as f:
                f.write(b"@stale\nA\n+\nI\n")
        args = argv + ["-w", str(ws)] + (
            ["--device", "cpu"] if side == "p" else [])
        if case == "stale":
            assert _run(cli, args) == 0
        else:
            with pytest.raises(IOError, match="is not a fastq file"):
                _run(cli, args)
    want = _outputs(tmp_path / "wj" / "fastqchunks")
    got = _outputs(tmp_path / "wp" / "fastqchunks")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    assert "cell_chunk5_2.fastq.gz" in got
    assert ("cell_chunk0_2.fastq.gz" in got) == (case != "mate1_bad")


@pytest.mark.parametrize("nonallelic", [False, True])
def test_rescue_command_matches_the_jax_cli(front, tmp_path, nonallelic):
    d, _ = front
    got = _front_both(
        tmp_path, ["Rescue"] + (["-N"] if nonallelic else []), "RescueFastq",
        setup=lambda ws: shutil.copytree(d / "Global_bams",
                                         ws / "Global_bams"))
    assert len(got) == 1 + len(os.listdir(d / "Global_bams"))
    assert sum(v.count(b"\n") for v in got.values()) > 40
    m = _metrics(tmp_path, "Rescue")
    assert "Rescue.total" in m and all(
        k.rsplit(".", 1)[-1] in ("read", "scan", "write", "total")
        for k in m)


MAPPING = {"global": ["GlobalMapping"],
           "global_bam": ["GlobalMapping", "--bam-format"],
           "global_pbs": ["GlobalMapping", "-m", "PBS", "-pt", "3", "2"],
           "remap": ["ReMapping"],
           "remap_bam": ["ReMapping", "--bam-format"]}


@pytest.mark.parametrize("case", sorted(MAPPING))
def test_mapping_commands_match_the_jax_cli(front, tmp_path, case):
    """``--fake-aligner`` against the two haplotype FASTAs (PBS mode runs
    as WS with it, as in the JAX CLI)."""
    d, data = front
    argv = MAPPING[case] + ["--fake-aligner", "-i"] + data["haplotypes"]
    src, stage = (("fq", "fastqchunks"), "Global_bams") if \
        case.startswith("global") else (("RescueFastq", "RescueFastq"),
                                        "ReMap_bams")
    got = _front_both(tmp_path, argv, stage, setup=lambda ws: shutil.copytree(
        d / src[0], ws / src[1]))
    fmt = ".bam" if case.endswith("bam") else ".sam"
    files = [k for k in got if k != ".hichap_stage_done"]
    assert files and all(k.endswith(fmt) for k in files)
    assert sum(v.count(b"\n") for v in got.values()) > 40 or fmt == ".bam"
    m = _metrics(tmp_path, MAPPING[case][0])
    steps = {"index", "read", "search", "sort", "write"}
    assert {k.rsplit(".", 1)[-1] for k in m} == steps | {"total"}
    assert {k.split(".")[1] for k in m if k.count(".") == 2} == {
        "Maternal", "Paternal"}


def test_bam_format_in_pbs_mode_is_refused_as_in_the_jax_cli(front,
                                                            tmp_path):
    d, data = front
    argv = ["GlobalMapping", "-m", "PBS", "--bam-format", "-i"] + \
        data["haplotypes"]
    for side, cli in (("j", JCLI), ("p", PCLI)):
        extra = ["--device", "cpu"] if side == "p" else []
        with pytest.raises(SystemExit, match="requires WS mode"):
            _run(cli, argv + ["-w", str(tmp_path / side)] + extra)


def test_module_entry_point_maps_with_the_fake_aligner(front, tmp_path):
    d, data = front
    shutil.copytree(d / "fq", tmp_path / "ws" / "fastqchunks")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "hichap_master_tpu_torch.cli",
                        "GlobalMapping", "--fake-aligner", "-w",
                        str(tmp_path / "ws"), "--device", "cpu", "-i"]
                       + data["haplotypes"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = sorted(os.listdir(tmp_path / "ws" / "Global_bams"))
    assert len(out) == 1 + len(os.listdir(d / "Global_bams"))


def test_matrix_names_a_missing_genome_size_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="rebuildG"):
        _run(PCLI, ["matrix", "-w", str(tmp_path / "ws"), "-b", "beds",
                    "-o", str(tmp_path / "out"), "-gs", "missing_file",
                    "--device", "cpu"])


# ------------------------------------------------------------------ chains
def _run(cli, argv):
    """One in-process CLI call; the root logging handlers and the
    excepthook it installs are removed again."""
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


def _jax_start(N, q, dtype=torch.float32, *, device, seed=0):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (N, q), jnp.float32))).to(device, dtype)


def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            data = obj[()] if isinstance(obj, h5py.Dataset) else None
            out[name] = (dict(obj.attrs), data)
        f.visititems(visit)
        out["/"] = (dict(f.attrs), None)
    return out


def _same_cooler(got_path, want_path, float_rtol=0.0):
    got, want = _h5_tree(got_path), _h5_tree(want_path)
    assert list(got) == list(want)
    for name, (wa, wd) in want.items():
        ga, gd = got[name]
        assert list(ga) == list(wa), name
        for k, v in wa.items():
            if k == "sum" and float_rtol and isinstance(v, np.floating):
                np.testing.assert_allclose(ga[k], v, rtol=float_rtol)
            else:
                assert type(ga[k]) is type(v) and np.all(ga[k] == v), \
                    (name, k, ga[k], v)
        if wd is None:
            assert gd is None, name
            continue
        assert gd.dtype == wd.dtype and gd.shape == wd.shape, name
        if name.endswith("bins/weight"):
            assert_close_nan(gd, wd, rtol=1e-4, label=name)
        elif name.endswith("pixels/count") and wd.dtype.kind == "f":
            np.testing.assert_allclose(gd, wd, rtol=float_rtol, atol=1e-9,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gd, wd, name)


def _same_npz(got_path, want_path):
    got = np.load(got_path, allow_pickle=True)
    want = np.load(want_path, allow_pickle=True)
    assert list(got) == list(want)
    for key in want:
        g, w = got[key].item(), want[key].item()
        assert list(g) == list(w)
        for label in w:
            np.testing.assert_array_equal(g[label], w[label])


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _same_outputs(want, got, close=None):
    """Two output files (or directories, file by file) line for line;
    ``close`` = (name tag, atol, rtol) compares the numbers of the files
    whose name holds the tag."""
    if os.path.isdir(want):
        names = sorted(os.listdir(want))
        assert names == sorted(os.listdir(got))
        for name in names:
            _same_outputs(os.path.join(want, name), os.path.join(got, name),
                          close)
        return names
    lw, lg = _lines(want), _lines(got)
    assert len(lg) == len(lw), want
    if not (close and close[0] in os.path.basename(want)):
        assert lg == lw, want
        return [want]
    for x, y in zip(lw, lg):
        for a, b in zip(x.split("\t"), y.split("\t")):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, want
                continue
            np.testing.assert_allclose(fb, fa, atol=close[1], rtol=close[2],
                                       err_msg=want)
    return [want]


@pytest.fixture(scope="module")
def beds(tmp_path_factory):
    """Allelic beds (planted loops and domains) and the same pairs as one
    valid bed, with their genome-size file."""
    d = tmp_path_factory.mktemp("cli")
    lengths = list(LENGTHS.values())
    classes = allelic_pairs(lengths, COUNTS, seed=3, device="cpu",
                            cis_floor=0.1, loops=planted_loops(lengths))
    Genome(LENGTHS).write(str(d / "genomeSize"))
    write_allelic_beds(str(d / "allelic"), PREFIX, classes, list(LENGTHS))
    os.makedirs(d / "valid")
    pairs = [torch.cat([c[i] for c in classes.values()]) for i in range(4)]
    write_valid_bed(str(d / "valid" / f"{PREFIX}Valid.bed"), pairs,
                    list(LENGTHS))
    return d


def _both(d, argv):
    """``argv`` through the JAX CLI (workspace ``d/wj``, outputs under
    ``d/j``) and the port's (``d/wp``, ``d/p``, ``--device cpu``); ``{o}``
    in an argument is the side's output root."""
    for cli, side in ((JCLI, "j"), (PCLI, "p")):
        args = [a.replace("{o}", str(d / side)) for a in argv]
        args += ["-w", str(d / f"w{side}")]
        if cli is PCLI:
            args += ["--device", "cpu"]
        assert _run(cli, args) == 0, (side, args)
    return d / "j", d / "p"


def _metrics(d, command):
    with open(d / "wp" / "Metrics" / f"{command}.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def allelic_chain(beds):
    """``matrix`` on the allelic beds through both CLIs."""
    j, p = _both(beds, ["matrix", "-b", str(beds / "allelic"), "-o",
                        "{o}/mat", "-gs", str(beds / "genomeSize"),
                        "-wR", str(RES_W), "-lR", str(RES_L),
                        "-region", "2000000"])
    return beds, {k: str(p / "mat" / "Cooler" / f"{PREFIX}{k}")
                  for k in ("Traditional_Multi.cool",
                            "UnImputated_Haplotype_Multi.cool",
                            "Imputated_Haplotype_Multi.cool",
                            "Imputated_Gap.npz")}


def test_matrix_command_matches_the_jax_cli(allelic_chain):
    d, files = allelic_chain
    jdir = d / "j" / "mat" / "Cooler"
    for name, path in files.items():
        want = str(jdir / os.path.basename(path))
        if name.endswith(".npz"):
            _same_npz(path, want)
        else:
            _same_cooler(path, want, 1e-5 if "Imputated_H" in name else 0.0)
    assert _lines(str(jdir / "Hap_genomeSize")) == _lines(
        str(d / "p" / "mat" / "Cooler" / "Hap_genomeSize"))
    m = _metrics(d, "matrix")
    assert {"matrix.total", "matrix.parse", "matrix.pass1", "matrix.vote",
            "matrix.correction", "matrix.cooler_write"} <= set(m)
    assert all(k.startswith("matrix.") and v >= 0 for k, v in m.items())


def test_analysis_commands_match_the_jax_cli(allelic_chain, monkeypatch):
    monkeypatch.setattr(PCA, "start_block", _jax_start)
    d, files = allelic_chain
    trad = files["Traditional_Multi.cool"]
    imp = files["Imputated_Haplotype_Multi.cool"]
    gap = files["Imputated_Gap.npz"]
    comp = ("Compartment", 1e-6, 0)
    j, p = _both(d, ["compartment", "-c", trad, "-R", str(RES_W), "-o",
                     "{o}/comp/T"])
    _same_outputs(str(j / "comp" / "T"), str(p / "comp" / "T"), comp)
    trad_pc = str(p / "comp" / "T" / "T_Compartment_500K.txt")
    for a in ("Maternal", "Paternal"):
        _both(d, ["compartment", "-c", imp, "-R", str(RES_W), "-A", a,
                  "-o", f"{{o}}/comp/{a[0]}", "--traditional-pc", trad_pc])
        _same_outputs(str(j / "comp" / a[0]), str(p / "comp" / a[0]),
                      ("Compartment", 1e-5, 0))
        _both(d, ["tads", "-c", imp, "-R", str(RES_L), "-A", a, "-o",
                  f"{{o}}/tads/{a[0]}"])
        names = _same_outputs(str(j / "tads" / a[0]), str(p / "tads" / a[0]),
                              ("_DI_", 1e-6, 1e-6))
        assert len(names) == 4
        _both(d, ["loops", "-c", imp, "-R", str(RES_L), "-A", a, "-o",
                  f"{{o}}/loops/{a[0]}", "--gap-file", gap])
        _same_outputs(str(j / "loops" / a[0]), str(p / "loops" / a[0]))
    _both(d, ["loops", "-c", trad, "-R", str(RES_L), "-o", "{o}/loops/T"])
    _same_outputs(str(j / "loops" / "T"), str(p / "loops" / "T"))
    called = _lines(str(p / "loops" / "M" / "Cluster_M_Loops_40K.txt"))[1:]
    assert called, "the planted loops should be called"
    assert len(_lines(str(p / "tads" / "M" / "M_Domain_40K.txt"))) > 5

    # the specificity tests on the port's calls
    loop_file = d / "loop_positions.txt"
    loop_file.write_text("chr\tstartM\tendM\tstartP\tendP\n" + "".join(
        "{0}\t{1}\t{2}\t{1}\t{2}\n".format(*l.split("\t")[:3])
        for l in called))
    bound_file = d / "boundary_pairs.txt"
    bound_file.write_text("".join(
        "{0}\t{1}\t{1}\n".format(*l.split("\t")) for l in
        _lines(str(p / "tads" / "M" / "M_All_Boundary_40K.txt"))))
    pcs = [str(p / "comp" / h / f"{h}_Compartment_500K.txt") for h in "MP"]
    for kind, argv, close in (
            ("loop", ["-c", imp, "-R", str(RES_L), "-i", str(loop_file)],
             None),
            ("boundary", ["-c", imp, "-R", str(RES_L), "-i",
                          str(bound_file)], ("boundary", 0, 1e-12)),
            ("compartment", ["-R", str(RES_W), "-i", *pcs], None)):
        _both(d, ["specificity", kind, *argv, "-o", f"{{o}}/{kind}.txt"])
        assert len(_lines(str(p / f"{kind}.txt"))) > 1, kind
        _same_outputs(str(j / f"{kind}.txt"), str(p / f"{kind}.txt"), close)
    for command in ("compartment", "tads", "loops", "specificity"):
        assert set(_metrics(d, command)) == {f"{command}.total"}


def test_nonallelic_chain_matches_the_jax_cli(beds, monkeypatch):
    monkeypatch.setattr(PCA, "start_block", _jax_start)
    j, p = _both(beds, ["matrix", "-N", "-b", str(beds / "valid"), "-o",
                        "{o}/matN", "-gs", str(beds / "genomeSize"),
                        "-wR", str(RES_W), "-lR", str(RES_L)])
    names = sorted(os.listdir(p / "matN" / "Cooler"))
    assert names == sorted(os.listdir(j / "matN" / "Cooler")) == [
        f"{PREFIX}Multi.cool", "Merged_Multi.cool"]
    for name in names:
        _same_cooler(str(p / "matN" / "Cooler" / name),
                     str(j / "matN" / "Cooler" / name))
    assert {"matrix.total", "matrix.parse", "matrix.build",
            "matrix.cooler_write"} <= set(_metrics(beds, "matrix"))
    merged = str(p / "matN" / "Cooler" / "Merged_Multi.cool")
    _both(beds, ["compartment", "-c", merged, "-R", str(RES_W), "-o",
                 "{o}/N/comp", "-r"])    # --resume skips nothing here
    _same_outputs(str(j / "N" / "comp"), str(p / "N" / "comp"),
                  ("Compartment", 1e-6, 0))
    _both(beds, ["tads", "-c", merged, "-R", str(RES_L), "-o",
                 "{o}/N/tads"])
    _same_outputs(str(j / "N" / "tads"), str(p / "N" / "tads"),
                  ("_DI_", 1e-6, 1e-6))
    _both(beds, ["loops", "-c", merged, "-R", str(RES_L), "-o",
                 "{o}/N/loops"])
    _same_outputs(str(j / "N" / "loops"), str(p / "N" / "loops"))


def test_plots_are_refused_through_the_cli(allelic_chain, monkeypatch):
    """Without matplotlib (as on the card's host) ``tads --plot`` writes
    the text outputs and then fails with the ImportError that names
    matplotlib, as the JAX CLI does."""
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d, files = allelic_chain
    with pytest.raises(ImportError, match="matplotlib"):
        _run(PCLI, ["tads", "-c", files["Traditional_Multi.cool"], "-R",
                    str(RES_L), "-o", str(d / "plot"), "--plot", "-w",
                    str(d / "wp"), "--device", "cpu"])
    assert (d / "plot" / f"plot_Domain_{RES_L // 1000}K.txt").exists()
    assert not [f for f in os.listdir(d / "plot") if f.endswith(".pdf")]
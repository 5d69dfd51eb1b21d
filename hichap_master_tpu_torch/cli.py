"""hichap-torch command line: the sub-commands of ``hichap-tpu`` on the
port.

Every sub-command (``rebuildG``, ``rebuildF``, ``GlobalMapping``,
``Rescue``, ``ReMapping``, ``bamProcess``, ``filtering``, ``matrix``,
``compartment``, ``tads``, ``loops`` and ``specificity``) takes the JAX
package's flags and defaults (``hichap_master_tpu/cli.py``), with one flag
more: ``--device`` (default ``cuda``), the device every driver runs on.
With ``--device cuda`` and no card visible the command fails; it never
falls back to the CPU.

``-r/--resume`` behaves as in the JAX CLI: ``rebuildG``, ``rebuildF``,
``GlobalMapping``, ``Rescue``, ``ReMapping`` and ``bamProcess`` write a
completion marker (``.hichap_stage_done``) into their output directory
and, with ``-r``, are skipped when the marker is there; the later
sub-commands write none and skip nothing.

``rebuildG`` reads the genome FASTA (``-g``) and, unless ``-N``, the SNP
table (``-S``), and writes ``<workspace>/genome`` (``-o``): ``Snps.npz``,
``genomeSize`` and per haplotype ``<hap>/<hap>.fa`` and
``<hap>/<enzyme>_<hap>_fragments.txt`` (``-N``: the genome's fragment
table); the substitution and the site search run on the device.
``rebuildF`` cuts the two FASTQ mates (``-1``, ``-2``) into chunks of
``-c`` reads under ``<workspace>/fastqchunks``; it runs on the host (it
has no device work; ``--device`` is checked all the same).
``GlobalMapping`` maps every chunk of ``<workspace>/fastqchunks`` (``-f``)
against each index (``-i``: Maternal then Paternal, or one) into
``<workspace>/Global_bams`` (``-o``); ``ReMapping`` maps the rescue FASTQs
of ``<workspace>/RescueFastq`` (``-f``) into ``<workspace>/ReMap_bams``,
each against its haplotype's index.  With ``--fake-aligner`` the indexes
are FASTA paths and the exact search runs on the device
(``pipeline.mapping.FakeAligner``); otherwise bowtie2 (``-b``) maps, in
WS mode on the host, its output name-sorted on the device, or in PBS mode
(``-m PBS``, ``-pt``, ``-mem``, ``-PBSlog``) through qsub, its raw SAM
kept.  ``--bam-format`` writes BAM (WS mode only; with
``--fake-aligner`` PBS mode runs as WS).  ``Rescue``
reads the chunk alignments of ``<workspace>/Global_bams`` (``-b``) and
writes the rescue FASTQs ``<stem>_unmapped.fq`` to
``<workspace>/RescueFastq`` (``-o``); the junction search runs on the
device.

``bamProcess`` reads the chunk alignments of ``<workspace>/Global_bams``
(``-gb``) and ``<workspace>/ReMap_bams`` (``-rb``) with the fragment
tables (``-f``, Maternal then Paternal; one with ``-N``) and the SNP table
(``-s``), and writes the chunk beds to ``<workspace>/UniqRawBed`` (``-o``).
``filtering`` reads the chunk beds of ``<workspace>/UniqRawBed`` (``-b``)
and writes ``<workspace>/Filtered_Bed`` (the valid beds) and, unless
``-N``, ``<workspace>/Allelic_Bed`` (``-o``: the five allelic beds that
``matrix -b`` reads); ``HICHAP_FILTER_BLOCK`` sets the records the card
holds at a time, as in the JAX package (else the free device memory
sizes it).

Each command writes ``<workspace>/Metrics/<command>.json``: the command's
wall seconds under ``<command>.total`` and the seconds of each step its
drivers time, under ``<command>.<step>`` (``rebuildG.<step>``: ``snps``,
``read``, ``substitute``, ``sites``, ``write``, ``index``;
``rebuildF.mate1`` / ``.mate2``; ``GlobalMapping.<tag>.<step>`` and
``ReMapping.<tag>.<step>``: ``index``, ``read``, ``search``, ``sort``,
``write``, the tag ``Maternal``, ``Paternal`` or the index's name (none
for ReMapping's one index); ``Rescue.<file>.<step>``: ``read``,
``scan``, ``write``; ``bamProcess.<haplotype>.<step>``,
``filtering.<haplotype>.<step>`` for each ``hic_filtering`` call and
``filtering.allelic.<step>``).

    hichap-torch rebuildG -w ws -g hg19.fa -S snps.txt -e MboI
    hichap-torch rebuildF -w ws -1 cell_R1_1.fastq.gz -2 cell_R1_2.fastq.gz
    hichap-torch GlobalMapping -w ws --fake-aligner \
        -i ws/genome/Maternal/Maternal.fa ws/genome/Paternal/Paternal.fa
    hichap-torch Rescue -w ws -e MboI
    hichap-torch ReMapping -w ws --fake-aligner \
        -i ws/genome/Maternal/Maternal.fa ws/genome/Paternal/Paternal.fa

    hichap-torch bamProcess -w ws -f M_fragments.txt P_fragments.txt -s snps.npz
    hichap-torch filtering -w ws
    hichap-torch matrix -b ws/Allelic_Bed -o out -gs genomeSize -wR 500000
    hichap-torch compartment -c out/Cooler/X_Traditional_Multi.cool -R 500000 -o T
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .utils import profiling
from .utils.logging import get_logger, setup_logging

log = get_logger("hichap_master_tpu_torch.cli")

# the workspace directories of hichap-tpu that these sub-commands use
WS_DIRS = {"genome": "genome", "chunks": "fastqchunks",
           "global": "Global_bams", "rescue": "RescueFastq",
           "remap": "ReMap_bams", "rawbed": "UniqRawBed",
           "filtered": "Filtered_Bed", "allelic": "Allelic_Bed"}
# hichap-tpu's completion marker of the resumable stages, and the
# directory each of them writes by default
_DONE_MARK = ".hichap_stage_done"
_STAGE_OUT = {"rebuildG": "genome", "rebuildF": "chunks",
              "GlobalMapping": "global", "Rescue": "rescue",
              "ReMapping": "remap", "bamProcess": "rawbed"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hichap-torch",
        description="diploid Hi-C analysis on PyTorch and CUDA")
    parser.add_argument("-v", "--version", action="version",
                        version="%(prog)s 0.1.0")
    sub = parser.add_subparsers(dest="command")

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("-log", "--logfile", default="HiCHap.log")
    common.add_argument("-w", "--workspace", default="hichap_workspace")
    common.add_argument("-r", "--resume", action="store_true", default=False,
                        help="skip rebuildG, rebuildF, GlobalMapping, "
                             "Rescue, ReMapping or bamProcess when its "
                             "output directory holds its completion marker "
                             "(the other sub-commands write none and skip "
                             "nothing)")
    common.add_argument("--device", default="cuda",
                        help="torch device of every driver (default cuda; "
                             "no fallback to the CPU)")

    p = sub.add_parser("rebuildG", parents=[common],
                       help="rebuild parental genomes from phased SNPs")
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-S", "--Snp", default=None)
    p.add_argument("-e", "--enzyme", default="MboI")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("rebuildF", parents=[common],
                       help="split FASTQ mates into tagged chunks (host)")
    p.add_argument("-1", "--fastq1", required=True)
    p.add_argument("-2", "--fastq2", required=True)
    p.add_argument("-c", "--chunksize", type=int, default=4_000_000)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-o", "--out", default=None)

    for name in ("GlobalMapping", "ReMapping"):
        p = sub.add_parser(name, parents=[common],
                           help=f"{name} with bowtie2 or the fake aligner")
        p.add_argument("-b", "--bowtie2Path", default="bowtie2")
        p.add_argument("-f", "--fastq", default=None)
        p.add_argument("-i", "--bowtieIndex", nargs="+", required=True)
        p.add_argument("-o", "--out", default=None)
        p.add_argument("-m", "--mode", choices=["PBS", "WS"], default="WS")
        p.add_argument("-wt", "--WSthreads", type=int, default=16)
        p.add_argument("-pt", "--PBSthreads", type=int, nargs="+",
                       default=[20, 4])
        p.add_argument("-mem", "--memory", type=int, default=10)
        p.add_argument("-PBSlog", "--PBSlogfile", default=None)
        p.add_argument("--fake-aligner", action="store_true", default=False,
                       help="use the exact-match FakeAligner on the device "
                            "(indexes are FASTA paths)")
        p.add_argument("--bam-format", action="store_true", default=False,
                       help="store mapped chunks as BGZF .bam instead of "
                            "SAM text; WS mode only")

    p = sub.add_parser("Rescue", parents=[common],
                       help="cut unmapped reads at ligation junctions")
    p.add_argument("-b", "--bam", default=None)
    p.add_argument("-e", "--enzyme", default="MboI")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("bamProcess", parents=[common],
                       help="integrate alignments into bed records")
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-gb", "--Globalbam", default=None)
    p.add_argument("-rb", "--Rebam", default=None)
    p.add_argument("-f", "--fragments", nargs="+", required=True)
    p.add_argument("-s", "--snp", default=None)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--rfo", action="store_true", default=False,
                   help="relaxed uniqueness: keep best-scoring multireads")
    p.add_argument("--readlen", type=int, default=150,
                   help="uncut-mate read length sentinel")

    p = sub.add_parser("filtering", parents=[common],
                       help="HiC noise filtering + allelic assignment")
    p.add_argument("-b", "--bed", default=None)
    p.add_argument("-uc", "--unclean", action="store_true", default=False)
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("matrix", parents=[common],
                       help="contact matrices + correction + cooler output")
    p.add_argument("-b", "--bedPath", nargs="+", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-N", "--NonAllelic", action="store_true", default=False)
    p.add_argument("-gs", "--genomeSize", required=True)
    p.add_argument("-wR", "--wholeRes", nargs="+", type=int, default=None)
    p.add_argument("-lR", "--localRes", nargs="+", type=int,
                   default=[500_000, 40_000])
    p.add_argument("-ratio", "--ImputationRatio", type=float, default=0.9)
    p.add_argument("-min", "--ImputationMin", type=int, default=2)
    p.add_argument("-region", "--ImputationRegion", type=int,
                   default=10_000_000)
    p.add_argument("-C", "--chroms", nargs="*", default=["#", "X"])

    p = sub.add_parser("compartment", parents=[common])
    p.add_argument("-c", "--cooler", required=True)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-A", "--allelic", default="False",
                   choices=["False", "Maternal", "Paternal"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--traditional-pc", default=None)
    p.add_argument("--sliding", action="store_true", default=False)
    p.add_argument("--plot", action="store_true", default=False)
    p.add_argument("--pc-selector", default="new", choices=["new", "legacy"])

    p = sub.add_parser("tads", parents=[common])
    p.add_argument("-c", "--cooler", required=True)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-A", "--allelic", default="False",
                   choices=["False", "Maternal", "Paternal"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--minTAD", type=int, default=200_000)
    p.add_argument("--maxTAD", type=int, default=4_000_000)
    p.add_argument("--state-num", type=int, default=3, choices=[3, 5, 6])
    p.add_argument("--window", type=int, default=600_000)
    p.add_argument("--test-type", default="ttest",
                   choices=["ttest", "chitest"])
    p.add_argument("--plot", action="store_true", default=False)

    p = sub.add_parser("loops", parents=[common])
    p.add_argument("-c", "--cooler", required=True)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-A", "--allelic", default="False",
                   choices=["False", "Maternal", "Paternal"])
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--gap-file", default=None)
    p.add_argument("--loop-ratio", type=float, default=0.6)
    p.add_argument("--loop-strength", type=float, default=16)

    p = sub.add_parser("specificity", parents=[common])
    p.add_argument("kind", choices=["loop", "boundary", "compartment"])
    p.add_argument("-c", "--cooler", default=None)
    p.add_argument("-R", "--resolution", type=int, required=True)
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="loop/boundary file, or maternal+paternal PC files")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--offset", type=int, default=10)

    return parser


def _ws(args, key: str) -> str:
    """``<workspace>/<WS_DIRS[key]>``, made if missing."""
    d = os.path.join(args.workspace, WS_DIRS[key])
    os.makedirs(d, exist_ok=True)
    return d


def _rebuild_genome(parser, args, dev, walls) -> None:
    """``build_raw_genome`` (``-N``), or ``snps_integration`` then
    ``rebuild_genome``, as the JAX CLI runs them."""
    from .pipeline.genome_rebuild import (build_raw_genome, rebuild_genome,
                                          snps_integration)

    out = args.out or _ws(args, "genome")
    os.makedirs(out, exist_ok=True)
    if args.NonAllelic:
        build_raw_genome(args.genome, args.enzyme, out, args.threads,
                         device=dev, walls=walls)
        return
    if not args.Snp:
        parser.error("rebuildG needs -S/--Snp unless -N")
    with profiling.step(walls, "snps", dev):
        npz = snps_integration(args.Snp, out)
    rebuild_genome(args.genome, npz, args.enzyme, out, args.threads,
                   device=dev, walls=walls)


def _split_fastq(args, walls) -> None:
    """``split_reads`` of both mates, on the host (the stage has no device
    work).  The two mates run on two threads at once (each inflates its
    input on one thread); mate 2 is split into ``<out>/.mate2`` and its
    chunks are moved into ``<out>`` once mate 1 has ended.  Where mate 1
    fails they are thrown away, and where mate 2 fails they are moved as
    far as they go.  So the output directory, after a failure too, is the
    JAX CLI's, which splits mate 1 and then mate 2."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from .pipeline.chunking import chunk_path, split_reads, stale_chunk

    out = args.out or _ws(args, "chunks")
    stage = os.path.join(out, ".mate2")
    shutil.rmtree(stage, ignore_errors=True)

    def one(mate, fq, folder):
        with profiling.step(walls, f"mate{mate}", "cpu"):
            return split_reads(fq, folder, args.chunksize, mate)

    def move():
        for f in sorted(os.listdir(stage)) if os.path.isdir(stage) else ():
            os.replace(os.path.join(stage, f), os.path.join(out, f))
        shutil.rmtree(stage, ignore_errors=True)

    with ThreadPoolExecutor(2) as ex:
        first = ex.submit(one, 1, args.fastq1, out)
        second = ex.submit(one, 2, args.fastq2, stage)
        try:
            first.result()
        except BaseException:
            second.exception()                 # mate 2 has ended
            shutil.rmtree(stage, ignore_errors=True)
            raise
        try:
            counts = second.result()
        finally:
            move()
    last = chunk_path(args.fastq2, out, len(counts), 2)
    if stale_chunk(counts, args.chunksize) and os.path.exists(last):
        os.remove(last)          # as split_reads removes it in its folder


def _mapping(args, dev, walls) -> None:
    """``ws_mapping`` / ``ws_rescue_mapping`` (or, with ``-m PBS`` and
    bowtie2, ``pbs_mapping`` / ``pbs_rescue_mapping``), as the JAX CLI runs
    them: ``--bam-format`` is refused in PBS mode unless
    ``--fake-aligner``, which always runs in WS mode."""
    from .pipeline.mapping import (Bowtie2Aligner, FakeAligner, pbs_mapping,
                                   pbs_rescue_mapping, ws_mapping,
                                   ws_rescue_mapping)

    is_global = args.command == "GlobalMapping"
    fastq = args.fastq or _ws(args, "chunks" if is_global else "rescue")
    out = args.out or _ws(args, "global" if is_global else "remap")
    fmt = "bam" if args.bam_format else "sam"
    pbs = args.mode == "PBS" and not args.fake_aligner
    if args.bam_format and pbs:
        raise SystemExit("--bam-format requires WS mode (PBS jobs "
                         "run bowtie2 one-liners that emit SAM)")
    aligner = (FakeAligner(device=dev) if args.fake_aligner
               else Bowtie2Aligner(args.bowtie2Path,
                                   max(1, args.WSthreads // 4), device=dev))
    pbs_kw = dict(cell="hichap", bowtie2=args.bowtie2Path,
                  threads=args.PBSthreads[1], num_task=args.PBSthreads[0],
                  mem_gb=args.memory, log_dir=args.PBSlogfile)
    if is_global:
        if pbs:
            pbs_mapping(fastq, out, args.bowtieIndex, **pbs_kw)
        else:
            ws_mapping(fastq, out, args.bowtieIndex, aligner=aligner,
                       out_format=fmt, device=dev, walls=walls)
        return
    tags = (["Maternal", "Paternal"] if len(args.bowtieIndex) == 2
            else [""])
    idx_by_tag = dict(zip(tags, args.bowtieIndex))
    if pbs:
        pbs_rescue_mapping(fastq, out, idx_by_tag, **pbs_kw)
    else:
        ws_rescue_mapping(fastq, out, idx_by_tag, aligner=aligner,
                          out_format=fmt, device=dev, walls=walls)


def _rescue(args, dev, walls) -> None:
    """``cutting_reads_to_remapping`` of every chunk alignment; as in the
    JAX CLI the haplotype mark never narrows the selection, and ``-N`` is
    accepted and changes nothing."""
    from .pipeline.rescue import cutting_reads_to_remapping

    cutting_reads_to_remapping(args.bam or _ws(args, "global"),
                               args.out or _ws(args, "rescue"), args.enzyme,
                               "NonAllelic", args.threads, device=dev,
                               walls=walls)


def _bam_process(args, dev, walls) -> None:
    """``bam_extract`` of the workspace's chunk alignments, as the JAX CLI
    runs it (``-rfo``: level 2)."""
    from .pipeline.bam_process import bam_extract

    bam_extract(args.Globalbam or _ws(args, "global"),
                args.Rebam or _ws(args, "remap"),
                args.out or _ws(args, "rawbed"), args.fragments, args.snp,
                threads=args.threads, level=2 if args.rfo else 1,
                allelic=not args.NonAllelic, read_len=args.readlen,
                device=dev, walls=walls)


def _filtering(args, dev, walls) -> None:
    """``hic_filtering`` of the chunk beds (NonAllelic, or Maternal and
    Paternal), then ``allelic_filtering`` of the two valid beds, as the JAX
    CLI runs them."""
    from .pipeline.filtering import allelic_filtering, hic_filtering

    def run(fn, name, *a, **kw):
        steps = {}
        fn(*a, **kw, device=dev, walls=steps)
        walls.update({f"{name}.{k}": v for k, v in steps.items()})

    bed = args.bed or _ws(args, "rawbed")
    if args.NonAllelic:
        out = args.out or _ws(args, "filtered")
        run(hic_filtering, "NonAllelic", bed, out, "NonAllelic",
            clean=not args.unclean)
        return
    filt = _ws(args, "filtered")
    for hap in ("Maternal", "Paternal"):
        run(hic_filtering, hap, bed, filt, hap, clean=not args.unclean)
    m_bed, p_bed = (next(os.path.join(filt, f) for f in sorted(
        os.listdir(filt)) if f"{hap}_Valid" in f)
        for hap in ("Maternal", "Paternal"))
    run(allelic_filtering, "allelic", m_bed, p_bed,
        args.out or _ws(args, "allelic"))


def _device(parser, name: str):
    """The torch device ``name``; a CUDA device that is not visible is an
    error."""
    import torch

    try:
        dev = torch.device(name)
    except RuntimeError as e:
        parser.error(f"--device {name}: {e}")
    if dev.type == "cuda":
        if not torch.cuda.is_available() or (
                dev.index or 0) >= torch.cuda.device_count():
            parser.error(f"--device {name}: no such CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 1
    dev = _device(parser, args.device)
    os.makedirs(args.workspace, exist_ok=True)
    setup_logging(os.path.join(args.workspace, args.logfile))
    log.log(21, "hichap-torch %s args: %s", args.command, vars(args))
    stage_dir = None
    if args.command in _STAGE_OUT:
        stage_dir = args.out or os.path.join(
            args.workspace, WS_DIRS[_STAGE_OUT[args.command]])
        if args.resume and os.path.exists(os.path.join(stage_dir,
                                                       _DONE_MARK)):
            log.log(21, "resume: stage completed previously under %s — "
                    "skipping", stage_dir)
            return 0
    profiling.reset_metrics()
    walls = {}
    t_start = time.perf_counter()
    allelic = (False if getattr(args, "allelic", "False") == "False"
               else args.allelic)

    if args.command == "rebuildG":
        _rebuild_genome(parser, args, dev, walls)

    elif args.command == "rebuildF":
        _split_fastq(args, walls)

    elif args.command in ("GlobalMapping", "ReMapping"):
        _mapping(args, dev, walls)

    elif args.command == "Rescue":
        _rescue(args, dev, walls)

    elif args.command == "bamProcess":
        _bam_process(args, dev, walls)

    elif args.command == "filtering":
        _filtering(args, dev, walls)

    elif args.command == "matrix":
        from .pipeline.matrix import (haplotype_matrix_files,
                                      traditional_matrix_files)
        if not os.path.exists(args.genomeSize):
            hint = os.path.join(args.workspace, "genome", "genomeSize")
            raise FileNotFoundError(
                f"genomeSize file not found: {args.genomeSize!r}"
                + (f" (rebuildG wrote {hint})" if os.path.exists(hint)
                   else " (run rebuildG first; it writes "
                        "<workspace>/genome/genomeSize)"))
        if args.NonAllelic:
            traditional_matrix_files(
                args.out, args.bedPath, args.genomeSize,
                args.wholeRes or [], args.localRes, args.chroms,
                device=dev, walls=walls)
        else:
            haplotype_matrix_files(
                args.out, args.bedPath, args.genomeSize,
                args.wholeRes or [], args.localRes,
                imputation_region=args.ImputationRegion,
                imputation_min=args.ImputationMin,
                imputation_ratio=args.ImputationRatio, chroms=args.chroms,
                device=dev, walls=walls)

    elif args.command == "compartment":
        from .models.compartment import run_compartment
        run_compartment(args.cooler, args.resolution, allelic, args.out,
                        sliding=args.sliding,
                        traditional_pc_file=args.traditional_pc,
                        plot=args.plot, selector=args.pc_selector,
                        device=dev)

    elif args.command == "tads":
        from .models.tads import run_tads
        run_tads(args.cooler, args.resolution, allelic, args.out,
                 min_tad=args.minTAD, max_tad=args.maxTAD,
                 state_num=args.state_num, window=args.window,
                 test_type=args.test_type, plot=args.plot, device=dev)

    elif args.command == "loops":
        from .models.loops import run_loops
        run_loops(args.cooler, args.resolution, allelic, args.out,
                  gap_file=args.gap_file, loop_ratio=args.loop_ratio,
                  loop_strength=args.loop_strength, device=dev)

    elif args.command == "specificity":
        from .models.specificity import (
            BoundaryAllelicSpecificity, CompartmentAllelicSpecificity,
            LoopAllelicSpecificity)
        if args.kind == "loop":
            test = LoopAllelicSpecificity.from_cooler(
                args.cooler, args.input[0], args.resolution, device=dev)
        elif args.kind == "boundary":
            test = BoundaryAllelicSpecificity.from_cooler(
                args.cooler, args.input[0], args.resolution, args.offset,
                device=dev)
        else:
            test = CompartmentAllelicSpecificity.from_files(
                args.input[0], args.input[1], args.resolution, device=dev)
        test.run(args.out)

    if stage_dir and os.path.isdir(stage_dir):
        with open(os.path.join(stage_dir, _DONE_MARK), "w") as f:
            f.write(args.command + "\n")
    for step, seconds in walls.items():
        profiling.add(f"{args.command}.{step}", seconds)
    _dump_stage_metrics(args, time.perf_counter() - t_start)
    return 0


def _dump_stage_metrics(args, total: float) -> None:
    """Persist the stage metrics (``utils/profiling.py``) plus the command
    total under ``<workspace>/Metrics/<command>.json``."""
    import json

    m = profiling.metrics()
    m[f"{args.command}.total"] = total
    mdir = os.path.join(args.workspace, "Metrics")
    os.makedirs(mdir, exist_ok=True)
    path = os.path.join(mdir, f"{args.command}.json")
    with open(path, "w") as f:
        json.dump(m, f, indent=2, sort_keys=True)
    log.log(21, "stage metrics written to %s", path)


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

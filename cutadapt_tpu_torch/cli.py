#!/usr/bin/env python
"""
cutadapt-tpu-torch {version}

Adapter trimming on an NVIDIA GPU with the reference cutadapt's
command-line surface and output semantics.

Usage:
    cutadapt-tpu-torch -a ADAPTER [options] [-o output.fastq] input.fastq

For paired-end reads:
    cutadapt-tpu-torch -a ADAPT1 -A ADAPT2 [options] -o out1.fastq -p out2.fastq in1.fastq in2.fastq

"ADAPTER" stands for the sequence of your 3' adapter; matching is
error-tolerant and IUPAC wildcards are understood. Every read from
input.fastq lands in output.fastq with the adapter removed. Give -a
several times to search several adapters, of which only the best match
per read is trimmed.

FASTA input works too. Compression (.gz, .xz, .bz2) is detected from
file names on both input and output, and '-' names stdin/stdout; with
no -o option, trimmed reads go to standard output.

"cutadapt-tpu-torch --help" lists all command-line options.

---

Structure of this module: the argument parser declares the ~80 options
(reference surface: cutadapt:src/cutadapt/cli.py:170-415); a
PipelineBuilder turns parsed arguments into the modifier/step pipeline;
main() wires input paths, runner selection (the GPU engine first, host
processes for runs it cannot express) and report rendering together.
"""
import copy
import itertools
import logging
import os
from collections import Counter
import multiprocessing
import platform
import shutil
import sys
import time
from argparse import SUPPRESS, ArgumentParser, HelpFormatter
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from cutadapt_tpu_torch import __version__, tracing
from cutadapt_tpu_torch.adapters import Adapter, InvalidCharacter, warn_duplicate_adapters
from cutadapt_tpu_torch.io.files import FileOpener, InputPaths, OutputFiles
from cutadapt_tpu_torch.io.records import FileFormatError, UnknownFileFormat
from cutadapt_tpu_torch.json_utils import OneLine
from cutadapt_tpu_torch.json_utils import dumps as json_dumps
from cutadapt_tpu_torch.log import REPORT, setup_logging
from cutadapt_tpu_torch.modifiers import (
    AdapterCutter, InvalidTemplate, LengthTagModifier, NEndTrimmer,
    NextseqQualityTrimmer, PairedAdapterCutter, PairedAdapterCutterError,
    PairedEndRenamer, PairedReverseComplementer, PolyATrimmer,
    PrefixSuffixAdder, QualityTrimmer, Renamer, ReverseComplementer,
    Shortener, SingleEndModifier, SuffixRemover, UnconditionalCutter,
    ZeroCapper,
)
from cutadapt_tpu_torch.parser import make_adapters_from_specifications
from cutadapt_tpu_torch.pipeline import PairedEndPipeline, SingleEndPipeline
from cutadapt_tpu_torch.predicates import (
    CasavaFiltered, IsTrimmed, IsUntrimmed, TooHighAverageErrorRate,
    TooLong, TooManyExpectedErrors, TooManyN, TooShort,
)
from cutadapt_tpu_torch.qualtrim import HasNoQualities
from cutadapt_tpu_torch.report import Statistics, full_report, minimal_report
from cutadapt_tpu_torch.accel import BatchRequiredError, DeviceError
from cutadapt_tpu_torch.runners import SerialPipelineRunner, make_runner
from cutadapt_tpu_torch.steps import (
    CombinatorialDemultiplexer, Demultiplexer, InfoFileWriter,
    PairedDemultiplexer, PairedEndFilter, PairedEndSink,
    PairedInfoFileWriter, PairedSingleEndStep, RestFileWriter,
    SingleEndFilter, SingleEndSink, WildcardFileWriter,
)
from cutadapt_tpu_torch.utils import DummyProgress, Progress, available_cpu_count

logger = logging.getLogger()


class CommandLineError(Exception):
    pass


class CutadaptArgumentParser(ArgumentParser):
    """
    ArgumentParser variant: usage is printed without the 'usage:'
    prefix, and errors show a one-line hint instead of the full usage.
    """

    class CustomUsageHelpFormatter(HelpFormatter):
        def __init__(self, *args, **kwargs):
            kwargs["width"] = min(24 + 80, shutil.get_terminal_size().columns)
            super().__init__(*args, **kwargs)

        def add_usage(self, usage, actions, groups, prefix=None):
            if usage is not SUPPRESS:  # pragma: no cover
                self._add_item(self._format_usage, (usage, actions, groups, ""))

    def __init__(self, *args, **kwargs):
        kwargs["formatter_class"] = self.CustomUsageHelpFormatter
        kwargs["usage"] = kwargs["usage"].replace("{version}", __version__)
        super().__init__(*args, **kwargs)

    def error(self, message):
        """Exit with a brief error message."""
        print(
            'Run "cutadapt-tpu-torch --help" to see command-line options.',
            file=sys.stderr,
        )
        self.exit(2, f"\n{self.prog}: error: {message}\n")


def _spec(kind):
    """argparse `type` for adapter options: tag the value with the
    adapter kind it was given as (-a/-g/-b and -A/-G/-B)."""
    return lambda x: (kind, x)


# The CLI option surface is data, not code: (group title, group
# description, ((flags, kwargs), ...)). The option and help STRINGS are
# the reference CLI's public contract (cutadapt cli.py:~140-580) and
# must render identically; the structure that carries them is our own —
# the same declarative-descriptor approach as adapters._KINDS and
# batch_pipeline._KIND_INFO.
_OPTION_GROUPS = (
    (
        'Options',
        None,
        (
        (('--debug',),
         dict(action='count', default=0, help='Print debug log. Use twice to also print DP matrices')),
        (('--profile',),
         dict(action='store_true', default=False, help=SUPPRESS)),
        (('-j', '--cores',),
         dict(type=int, default=1, help=(
          'Number of CPU cores to use. Use 0 to auto-detect. Default: '
          '%(default)s'))),
        (('--gc-content',),
         dict(type=float, default=50, help=SUPPRESS)),
        (('--buffer-size',),
         dict(type=int, default=4000000, help=SUPPRESS)),
        (('--no-index',),
         dict(action='store_false', dest='index', default=True, help=SUPPRESS)),
        # multi-process data parallelism: process shard INDEX of COUNT
        # (record-aligned byte range computed internally; see
        # parallel/multihost.py). Not part of the reference-compatible
        # help surface, hence suppressed.
        (('--shard',),
         dict(default=None, metavar='INDEX/COUNT', help=SUPPRESS)),
        ),
    ),
    (
        'Finding adapters',
        (
         'Parameters -a, -g, -b specify adapters to be removed from each '
         'read (or from R1 if data is paired-end. If specified multiple '
         'times, only the best matching adapter is trimmed (but see the '
         "--times option). Use notation 'file:FILE' to read adapter "
         'sequences from a FASTA file.'),
        (
        (('-a', '--adapter',),
         dict(action='append', dest='adapters', type=_spec('back'), default=[], metavar='ADAPTER', help=(
          "Sequence of a 3' adapter (on R1 for paired data). The adapter "
          "itself plus everything after it is removed. Append '$' to "
          'anchor it: the adapter then only counts as a match when it is '
          'a suffix of the read.'))),
        (('-g', '--front',),
         dict(action='append', dest='adapters', type=_spec('front'), default=[], metavar='ADAPTER', help=(
          "Sequence of a 5' adapter (on R1 for paired data). The adapter "
          'itself plus everything before it is removed; partial matches '
          "at the read start are recognized. Prepend '^' to anchor it: "
          'the adapter then only counts as a match when it is a prefix of '
          'the read.'))),
        (('-b', '--anywhere',),
         dict(action='append', dest='adapters', type=_spec('anywhere'), default=[], metavar='ADAPTER', help=(
          'Sequence of an adapter that may sit at either end (R1 for '
          'paired data); both the -a and -g match types are considered. '
          'If the match covers the first base of the read it is handled '
          'like -g, otherwise like -a. Intended for rescuing failed '
          'library preparations - avoid it when the ligation end is '
          'known!'))),
        (('-e', '--error-rate', '--errors',),
         dict(dest='error_rate', type=float, default=0.1, metavar='E', help=(
          'Maximum allowed error rate (if 0 <= E < 1), or absolute number '
          'of errors for full-length adapter match (if E is an integer >= '
          '1). Error rate = no. of errors divided by length of matching '
          'region. Default: %(default)s (10%%)'))),
        (('--no-indels',),
         dict(action='store_false', dest='indels', default=True, help=(
          'Allow only mismatches in alignments. Default: allow both '
          'mismatches and indels'))),
        (('-n', '--times',),
         dict(type=int, default=1, metavar='COUNT', help=(
          'Remove up to COUNT adapters from each read. Default: '
          '%(default)s'))),
        (('-O', '--overlap',),
         dict(type=int, default=3, metavar='MINLENGTH', help=(
          'Require MINLENGTH overlap between read and adapter for an '
          'adapter to be found. Default: %(default)s'))),
        (('--match-read-wildcards',),
         dict(action='store_true', default=False, help='Interpret IUPAC wildcards in reads. Default: %(default)s')),
        (('-N', '--no-match-adapter-wildcards',),
         dict(action='store_false', dest='match_adapter_wildcards', default=True, help='Do not interpret IUPAC wildcards in adapters.')),
        (('--action',),
         dict(choices=('trim', 'retain', 'mask', 'lowercase', 'crop', 'none'), default='trim', help=(
          'What to do if a match was found. trim: trim adapter and up- or '
          'downstream sequence; retain: trim, but retain adapter; mask: '
          "replace with 'N' characters; lowercase: convert to lowercase; "
          'crop: trim up and downstream sequence; none: leave unchanged. '
          'Default: %(default)s'))),
        (('--rc', '--revcomp',),
         dict(action='store_true', dest='reverse_complement', default=False, help=(
          'Match each adapter against the read and its reverse '
          'complement; when the reverse complement fits better, output '
          'that orientation. Default: check only the read as given'))),
        (('--no-trim',),
         dict(action='store_const', const='none', dest='action',
              help=SUPPRESS)),
        (('--mask-adapter',),
         dict(action='store_const', const='mask', dest='action',
              help=SUPPRESS)),
        ),
    ),
    (
        'Additional read modifications',
        None,
        (
        (('-u', '--cut',),
         dict(action='append', type=int, default=[], metavar='LEN', help=(
          'Unconditionally remove LEN bases from each read (R2: see -U); '
          'runs before adapter trimming. Positive LEN cuts from the '
          'start, negative from the end. May be given twice when the '
          'signs differ.'))),
        (('--nextseq-trim',),
         dict(type=int, default=None, metavar="3'CUTOFF", help=(
          'NextSeq-specific quality trimming (each read). Trims also dark '
          'cycles appearing as high-quality G bases.'))),
        (('-q', '--quality-cutoff',),
         dict(default=None, metavar="[5'CUTOFF,]3'CUTOFF", help=(
          "Trim low-quality bases from 5' and/or 3' ends of each read "
          'before adapter removal. Applied to both reads if data is '
          "paired. If one value is given, only the 3' end is trimmed. If "
          "two comma-separated cutoffs are given, the 5' end is trimmed "
          "with the first cutoff, the 3' end with the second."))),
        (('--quality-base',),
         dict(type=int, default=33, metavar='N', help=(
          'Assume FASTQ qualities are encoded as ascii(quality + N). Old '
          'Illumina data may need 64. Default: %(default)s'))),
        (('--poly-a',),
         dict(action='store_true', default=False, help='Trim poly-A tails')),
        (('--length', '-l',),
         dict(dest='length', type=int, default=None, metavar='LENGTH', help=(
          'Shorten reads to LENGTH (positive: drop the end; negative: '
          'drop the beginning). This and the following modifications run '
          'after adapter trimming.'))),
        (('--trim-n',),
         dict(action='store_true', default=False, help="Trim N's on ends of reads.")),
        (('--length-tag',),
         dict(default=None, metavar='TAG', help=(
          'Search for TAG followed by a decimal number in the description '
          'field of the read. Replace the decimal number with the correct '
          'length of the trimmed read. For example, use --length-tag '
          "'length=' to correct fields like 'length=123'."))),
        (('--strip-suffix',),
         dict(action='append', default=[], help=(
          'Remove this suffix from read names if present. Can be given '
          'multiple times.'))),
        (('-x', '--prefix',),
         dict(default='', help=(
          'Add this prefix to read names. Use {name} to insert the name '
          'of the matching adapter.'))),
        (('-y', '--suffix',),
         dict(default='', help='Add this suffix to read names; can also include {name}')),
        (('--rename',),
         dict(default=None, metavar='TEMPLATE', help=(
          'Rename reads using TEMPLATE containing variables such as {id}, '
          '{adapter_name} etc. (see documentation)'))),
        (('--zero-cap', '-z',),
         dict(action='store_true', dest='zero_cap', default=False, help='Change negative quality values to zero.')),
        ),
    ),
    (
        'Filtering of processed reads',
        (
         'Filters are applied after above read modifications. Paired-end '
         'reads are always discarded pairwise (see also --pair-filter).'),
        (
        (('-m', '--minimum-length',),
         dict(default=None, metavar='LEN[:LEN2]', help='Discard reads shorter than LEN. Default: 0')),
        (('-M', '--maximum-length',),
         dict(default=None, metavar='LEN[:LEN2]', help='Discard reads longer than LEN. Default: no limit')),
        (('--max-n',),
         dict(type=float, default=None, metavar='COUNT', help=(
          "Discard reads with more than COUNT 'N' bases. If COUNT is a "
          'number between 0 and 1, it is interpreted as a fraction of the '
          'read length.'))),
        (('--max-expected-errors', '--max-ee',),
         dict(dest='max_expected_errors', type=float, default=None, metavar='ERRORS', help=(
          'Discard reads whose expected number of errors (computed from '
          'quality values) exceeds ERRORS.'))),
        (('--max-average-error-rate', '--max-aer',),
         dict(dest='max_average_error_rate', type=float, default=None, metavar='ERROR_RATE', help=(
          'as --max-expected-errors (see above), but divided by length to '
          'account for reads of varying length.'))),
        (('--discard-trimmed', '--discard',),
         dict(action='store_true', dest='discard_trimmed', default=False, help=(
          'Discard reads that contain an adapter. Use also -O to avoid '
          'discarding too many randomly matching reads.'))),
        (('--discard-untrimmed', '--trimmed-only',),
         dict(action='store_true', dest='discard_untrimmed', default=False, help='Discard reads that do not contain an adapter.')),
        (('--discard-casava',),
         dict(action='store_true', default=False, help=(
          'Discard reads that did not pass CASAVA filtering (header has '
          ':Y:).'))),
        ),
    ),
    (
        'Output',
        None,
        (
        (('--quiet',),
         dict(action='store_true', default=False, help='Print only error messages.')),
        (('--report',),
         dict(choices=('full', 'minimal'), default=None, help=(
          "Which type of report to print: 'full' or 'minimal'. Default: "
          'full'))),
        (('--json',),
         dict(default=None, metavar='FILE', help='Dump report in JSON format to FILE')),
        (('-o', '--output',),
         dict(default=None, metavar='FILE', help=(
          'Write trimmed reads to FILE. FASTQ or FASTA format is chosen '
          'depending on input. Summary report is sent to standard output. '
          "Use '{name}' for demultiplexing (see docs). Default: write to "
          'standard output'))),
        (('--fasta',),
         dict(action='store_true', default=False, help='Output FASTA to standard output even on FASTQ input.')),
        (('--compression-level',),
         dict(type=int, default=1, metavar='N', help=(
          'Compression level for compressed output files. Default: '
          '%(default)s'))),
        (('-Z',),
         # level 1 is the default now
         dict(action='store_const', const=1, dest='compression_level',
              help=SUPPRESS)),
        (('--info-file',),
         dict(default=None, metavar='FILE', help=(
          'Write information about each read and its adapter matches into '
          'FILE. See the documentation for the file format.'))),
        (('-r', '--rest-file',),
         dict(default=None, metavar='FILE', help=(
          'When the adapter matches in the middle of a read, write the '
          'rest (after the adapter) to FILE.'))),
        (('--wildcard-file',),
         dict(default=None, metavar='FILE', help=(
          'When the adapter has N wildcard bases, write adapter bases '
          'matching wildcard positions to FILE. (Inaccurate with indels.)'))),
        (('--too-short-output',),
         dict(default=None, metavar='FILE', help=(
          'Write reads that are too short (according to length specified '
          'by -m) to FILE. Default: discard reads'))),
        (('--too-long-output',),
         dict(default=None, metavar='FILE', help=(
          'Write reads that are too long (according to length specified '
          'by -M) to FILE. Default: discard reads'))),
        (('--untrimmed-output',),
         dict(default=None, metavar='FILE', help=(
          'Write reads that do not contain any adapter to FILE. Default: '
          'output to same file as trimmed reads'))),
        ),
    ),
    (
        'Paired-end options',
        (
         'The -A/-G/-B/-U/-Q options work like their lowercase '
         'counterparts, but are applied to R2 (second read in pair)'),
        (
        (('-A',),
         dict(action='append', dest='adapters2', type=_spec('back'), default=[], metavar='ADAPTER', help="3' adapter to be removed from R2")),
        (('-G',),
         dict(action='append', dest='adapters2', type=_spec('front'), default=[], metavar='ADAPTER', help="5' adapter to be removed from R2")),
        (('-B',),
         dict(action='append', dest='adapters2', type=_spec('anywhere'), default=[], metavar='ADAPTER', help="5'/3 adapter to be removed from R2")),
        (('-U',),
         dict(action='append', dest='cut2', type=int, default=[], metavar='LENGTH', help='Remove LENGTH bases from R2')),
        (('-Q',),
         dict(dest='quality_cutoff2', default=None, metavar="[5'CUTOFF,]3'CUTOFF", help='Quality-trimming cutoff for R2. Default: same as for R1')),
        (('-L',),
         dict(dest='length2', type=int, default=None, metavar='LENGTH', help='Shorten R2 to LENGTH. Default: same as for R1')),
        (('-p', '--paired-output',),
         dict(default=None, metavar='FILE', help='Write R2 to FILE.')),
        (('--info-file-paired',),
         dict(dest='info_file2', default=None, metavar='FILE', help='Write info about R2 to FILE (see --info-file)')),
        (('--pair-adapters',),
         dict(action='store_true', default=False, help=(
          'Treat adapters given with -a/-A etc. as pairs. Either both or '
          'none are removed from each read pair.'))),
        (('--pair-filter',),
         dict(choices=('any', 'both', 'first'), default=None, help=(
          'Which of the reads in a paired-end read have to match the '
          'filtering criterion in order for the pair to be filtered. '
          'Default: any'))),
        (('--interleaved',),
         dict(action='store_true', default=False, help='Read and/or write interleaved paired-end reads.')),
        (('--untrimmed-paired-output',),
         dict(default=None, metavar='FILE', help=(
          'Write second read in a pair to this FILE when no adapter was '
          'found. Use with --untrimmed-output. Default: output to same '
          'file as trimmed reads'))),
        (('--too-short-paired-output',),
         dict(default=None, metavar='FILE', help='Write second read in a pair to this file if pair is too short.')),
        (('--too-long-paired-output',),
         dict(default=None, metavar='FILE', help='Write second read in a pair to this file if pair is too long.')),
        ),
    ),
)


def get_argument_parser() -> ArgumentParser:
    parser = CutadaptArgumentParser(
        usage=__doc__.partition("---")[0], add_help=False
    )
    for title, description, options in _OPTION_GROUPS:
        group = parser.add_argument_group(title, description=description)
        if title == "Options":
            group.add_argument(
                "-h", "--help", action="help",
                help="Show this help message and exit",
            )
            group.add_argument(
                "--version", action="version", version=__version__,
                help="Show version number and exit",
            )
        for flags, kwargs in options:
            group.add_argument(*flags, **kwargs)
    parser.add_argument("inputs", nargs="*", help=SUPPRESS)
    return parser


# --- small value parsers -----------------------------------------------------


def _ints(s: str, sep: str, bad: str, empty_as_none: bool = False):
    """Split `s` on `sep` and convert each piece to int; CommandLineError
    with message `bad` ({e} = conversion error) on garbage."""
    out = []
    for piece in s.split(sep):
        if empty_as_none and piece == "":
            out.append(None)
            continue
        try:
            out.append(int(piece))
        except ValueError as e:
            raise CommandLineError(bad.format(e=e))
    return out


def parse_cutoffs(s: str) -> Tuple[int, int]:
    """'INT[,INT]' -> (5', 3') cutoff pair; one value sets only 3'."""
    values = _ints(s, ",", "Quality cutoff value not recognized: {e}")
    if len(values) not in (1, 2):
        raise CommandLineError(
            "Expected one value or two values separated by comma"
            " for the quality cutoff"
        )
    return (0, values[0]) if len(values) == 1 else (values[0], values[1])


def parse_lengths(s: str) -> Tuple[Optional[int], ...]:
    """'[INT][:[INT]]' -> optional-int tuple ('25' -> (25,); '17:25' ->
    (17, 25); ':25' -> (None, 25))."""
    if s.count(":") > 1:
        raise CommandLineError("Only at most one colon is allowed")
    values = tuple(
        _ints(s, ":", "Value not recognized: {e}", empty_as_none=True)
    )
    if values == (None, None):
        raise CommandLineError(
            f"Cannot parse '{s}': At least one length needs to be given"
        )
    return values


# --- run-configuration checks ------------------------------------------------


def complain_about_duplicate_paths(paths: List[str]):
    real_files = [
        path for path in paths
        if path is not None
        # anything existing that is not a regular file (FIFO,
        # /dev/null, ...) may legitimately appear twice
        and not (Path(path).exists() and not Path(path).is_file())
    ]
    for path, count in Counter(real_files).items():
        if count > 1:
            raise CommandLineError(
                f"Path {path} specified more than once as an output"
                f" file. This is not supported at the moment."
            )


def determine_demultiplex_mode(
    output: Optional[str], paired_output: Optional[str]
) -> Union[str, bool]:
    """Return one of "normal", "combinatorial" or False."""
    templates = [t for t in (output, paired_output) if t]

    def in_all(marker):
        return bool(templates) and all(marker in t for t in templates)

    by_name = output is not None and "{name}" in output
    if paired_output is not None and by_name != ("{name}" in paired_output):
        raise CommandLineError(
            'When demultiplexing paired-end data, "{name}" must appear'
            " in both output file names (-o and -p)"
        )
    by_combination = (
        output is not None and paired_output is not None
        and in_all("{name1}") and in_all("{name2}")
    )
    if by_name and by_combination:
        raise CommandLineError(
            "You cannot combine {name} with {name1} and {name2}"
        )
    return (
        "normal" if by_name
        else "combinatorial" if by_combination
        else False
    )


# any of these argparse dests being set switches on paired-end mode
_PAIRED_TRIGGERS = (
    "paired_output", "interleaved", "adapters2", "cut2", "length2",
    "pair_filter", "untrimmed_paired_output", "too_short_paired_output",
    "too_long_paired_output", "quality_cutoff2", "info_file2",
)


def determine_paired(args) -> bool:
    """Whether any option enabling paired-end mode was used."""
    return any(getattr(args, dest) for dest in _PAIRED_TRIGGERS)


def make_input_paths(
    inputs: Sequence[str], paired: bool, interleaved: bool
) -> InputPaths:
    """Check input file names and return InputPaths."""
    n = len(inputs)
    if n == 0:
        raise CommandLineError(
            "You did not provide any input file names. Please give me"
            " something to do!"
        )
    if n > 2:
        listing = "\n - ".join(f"'{p}'" for p in inputs)
        raise CommandLineError(
            f"You provided {n} input file names, but either one or two"
            f" are expected. The file names were:\n - {listing}\nHint:"
            f" If your path contains spaces, you need to enclose it in"
            f" quotes"
        )
    want_two = paired and not interleaved
    if want_two and n == 1:
        raise CommandLineError(
            "You used an option that enables paired-end mode (such as"
            " -p, -A, -G, -B, -U), but only provided one input file."
            " Please either provide two input files or use use"
            " --interleaved as appropriate."
        )
    if not want_two and n == 2:
        raise CommandLineError(
            "It appears you want to trim paired-end data because you"
            " provided two input files, but then you also need to"
            " provide two output files (with -o and -p) or use the"
            " --interleaved option."
        )
    return InputPaths(*inputs, interleaved=interleaved)


def _apply_shard_option(args, input_paths, interleaved: bool) -> None:
    """--shard INDEX/COUNT: compute this run's record-aligned byte
    range over the input file(s) and install it as the
    CUTADAPT_TPU_TORCH_BYTE_RANGE contract every input opener honors
    (parallel/multihost.maybe_range_readers). main() restores the
    previous env value when the run finishes."""
    if not args.shard:
        return
    idx_s, sep, cnt_s = args.shard.partition("/")
    try:
        index, count = int(idx_s), int(cnt_s)
    except ValueError:
        raise CommandLineError(
            f"--shard must be INDEX/COUNT (e.g. 0/4), got {args.shard!r}"
        )
    if count < 1 or not 0 <= index < count:
        raise CommandLineError(
            f"--shard: INDEX must be in [0, COUNT), got {args.shard!r}"
        )
    from .parallel.multihost import shard_byte_range_env

    try:
        env = shard_byte_range_env(
            input_paths.paths, index, count, interleaved=interleaved
        )
    except ValueError as e:
        raise CommandLineError(str(e))
    os.environ["CUTADAPT_TPU_TORCH_BYTE_RANGE"] = env
    logger.debug("--shard %s -> byte range %s", args.shard, env)


# Declarative argument-sanity rules: (applies(args, paired), message).
# Messages are the reference CLI's exact error strings (contract).
_ARGUMENT_RULES = (
    (
        lambda a, paired: not paired and a.untrimmed_paired_output,
        "Option --untrimmed-paired-output can only be used when"
        " trimming paired-end reads.",
    ),
    (
        lambda a, paired: not paired and a.pair_adapters,
        "Option --pair-adapters can only be used when trimming"
        " paired-end reads",
    ),
    (
        lambda a, paired: (
            paired and not a.interleaved and not a.paired_output
        ),
        "When a paired-end trimming option such as -A/-G/-B/-U, is"
        " used, a second output file needs to be specified via -p"
        " (--paired-output).",
    ),
    (
        lambda a, paired: (
            paired and not a.interleaved and a.paired_output
            and not a.output
        ),
        "When you use -p or --paired-output, you must also use the"
        " -o option.",
    ),
)

_LATE_ARGUMENT_RULES = (
    (
        lambda a, paired: a.overlap < 1,
        "The overlap must be at least 1.",
    ),
    (
        lambda a, paired: not (0 <= a.gc_content <= 100),
        "GC content must be given as percentage between 0 and 100",
    ),
    (
        lambda a, paired: a.pair_adapters and a.times != 1,
        "--pair-adapters cannot be used with --times",
    ),
)


def check_arguments(args, paired: bool) -> None:
    for applies, message in _ARGUMENT_RULES:
        if applies(args, paired):
            raise CommandLineError(message)
    if paired and not args.interleaved:
        # filter-routing outputs must be given for both sides or neither
        for name in ("untrimmed", "too_short", "too_long"):
            r1 = getattr(args, f"{name}_output")
            r2 = getattr(args, f"{name}_paired_output")
            if bool(r1) != bool(r2):
                pretty = name.replace("_", "-")
                raise CommandLineError(
                    f"When trimming paired-end data, you must use either"
                    f" none or both of the --{pretty}-output/"
                    f"--{pretty}-paired-output options."
                )
    for applies, message in _LATE_ARGUMENT_RULES:
        if applies(args, paired):
            raise CommandLineError(message)


# --- pipeline assembly -------------------------------------------------------


class PipelineBuilder:
    """Turns parsed arguments into the modifier and step lists of a
    processing pipeline.

    Assembly order is semantics: side-channel writers run first, then
    length filters with their routed outputs, content filters, the
    trimmed/untrimmed routing, and finally the sink or demultiplexer;
    modifiers run cuts -> quality -> adapters -> poly-A -> shortening
    -> name edits (mirroring the reference's order,
    cutadapt:src/cutadapt/cli.py:635-999).
    """

    def __init__(self, args, input_file_format, outfiles, paired, adapters, adapters2):
        self._args = args
        self._format = input_file_format
        self._outfiles = outfiles
        self._paired = paired
        self._adapters = adapters
        self._adapters2 = adapters2
        self._pair_filter_mode = (
            ("any" if args.pair_filter is None else args.pair_filter)
            if paired
            else None
        )

    def build(self):
        steps = list(self._side_channel_writers())
        steps.extend(self._length_filters())
        steps.extend(self._content_filters())
        steps.extend(self._routing_and_sink())
        logger.debug("Pipeline steps:")
        for step in steps:
            logger.debug("- %s", step)
        modifiers = list(self._modifiers())
        if self._paired:
            return PairedEndPipeline(modifiers, steps)
        return SingleEndPipeline(modifiers, steps)

    # steps ------------------------------------------------------------

    def _wrap_single_end_step(self, step):
        return PairedSingleEndStep(step) if self._paired else step

    def _both_sides_filter(self, predicate, pair_filter_mode=None):
        """A filter applying one predicate to every read (pair)."""
        if not self._paired:
            return SingleEndFilter(predicate)
        return PairedEndFilter(
            predicate,
            predicate,
            pair_filter_mode=pair_filter_mode or self._pair_filter_mode,
        )

    def _filter_with_outputs(
        self, predicate1, predicate2, path1, path2, pair_filter_mode=None
    ):
        """A filter routing dropped reads to output files (if given)."""
        writer = None
        if path1 or path2:
            if self._paired and path2 is None:
                writer = self._outfiles.open_record_writer(
                    path1, interleaved=True
                )
            else:
                paths = [path1, path2] if self._paired else [path1]
                writer = self._outfiles.open_record_writer(*paths)
        if self._paired:
            return PairedEndFilter(
                predicate1, predicate2, writer,
                pair_filter_mode=pair_filter_mode or self._pair_filter_mode,
            )
        return SingleEndFilter(predicate1, writer)

    def _side_channel_writers(self):
        args, outfiles = self._args, self._outfiles
        if args.rest_file is not None:
            yield self._wrap_single_end_step(
                RestFileWriter(outfiles.open_text(args.rest_file))
            )
        if args.info_file is not None:
            if self._paired and args.info_file2 is not None:
                yield PairedInfoFileWriter(
                    outfiles.open_text(args.info_file),
                    outfiles.open_text(args.info_file2),
                )
            else:
                yield self._wrap_single_end_step(
                    InfoFileWriter(outfiles.open_text(args.info_file))
                )
        if args.wildcard_file is not None:
            yield self._wrap_single_end_step(
                WildcardFileWriter(outfiles.open_text(args.wildcard_file))
            )

    def _length_filters(self):
        args = self._args
        for length, path1, path2, predicate_class, option in (
            (args.minimum_length, args.too_short_output,
             args.too_short_paired_output, TooShort, "-m/--minimum-length"),
            (args.maximum_length, args.too_long_output,
             args.too_long_paired_output, TooLong, "-M/--maximum-length"),
        ):
            if length is None:
                if path1 or path2:
                    which = "short" if predicate_class is TooShort else "long"
                    bound = "minimum" if which == "short" else "maximum"
                    raise CommandLineError(
                        f"When --too-{which}-output or "
                        f"--too-{which}-paired-output are used, "
                        f"a {bound} length must be provided with {option}"
                    )
                continue
            if not self._paired and path2:
                raise CommandLineError(
                    "--too-short/long-paired-output cannot be used with single-end data"
                )
            bounds = parse_lengths(length)
            if not self._paired and len(bounds) == 2:
                raise CommandLineError(
                    "Two minimum or maximum lengths given for single-end data"
                )
            if self._paired and len(bounds) == 1:
                bounds = (bounds[0], bounds[0])
            predicate1 = (
                predicate_class(bounds[0]) if bounds[0] is not None else None
            )
            predicate2 = (
                predicate_class(bounds[1])
                if len(bounds) == 2 and bounds[1] is not None
                else None
            )
            yield self._filter_with_outputs(predicate1, predicate2, path1, path2)

    def _content_filters(self):
        args = self._args
        if args.max_n is not None:
            yield self._both_sides_filter(TooManyN(args.max_n))
        if args.max_expected_errors is not None:
            if not self._format.has_qualities():
                logger.warning(
                    "Ignoring option --max-ee because input does not provide quality values"
                )
            else:
                yield self._both_sides_filter(
                    TooManyExpectedErrors(args.max_expected_errors)
                )
        if args.max_average_error_rate is not None:
            if not self._format.has_qualities():
                logger.warning(
                    "Ignoring option --max-er because input does not contain quality values"
                )
            else:
                yield self._both_sides_filter(
                    TooHighAverageErrorRate(args.max_average_error_rate)
                )
        if args.discard_casava:
            yield self._both_sides_filter(CasavaFiltered())

    def _routing_and_sink(self):
        """The trimmed/untrimmed routing plus the final output step."""
        args = self._args
        untrimmed_requested = (
            args.untrimmed_output is not None
            or args.untrimmed_paired_output is not None
        )
        if (
            int(args.discard_trimmed)
            + int(args.discard_untrimmed)
            + int(untrimmed_requested)
        ) > 1:
            raise CommandLineError(
                "Only one of the --discard-trimmed, --discard-untrimmed "
                "and --untrimmed-output options can be used at the same time."
            )

        demultiplex_mode = determine_demultiplex_mode(
            args.output, args.paired_output
        )
        if demultiplex_mode:
            if args.discard_trimmed:
                raise CommandLineError(
                    "Do not use --discard-trimmed when demultiplexing."
                )
            yield self._demultiplexer(demultiplex_mode)
            return

        # Adapters on only one side would make pair-filter mode 'any'
        # declare every pair untrimmed; use 'both' instead then.
        override_mode = (
            self._paired
            and (not self._adapters2 or not self._adapters)
            and (args.discard_untrimmed or untrimmed_requested)
        )
        untrimmed_mode = "both" if override_mode else None

        if args.discard_trimmed:
            yield self._both_sides_filter(IsTrimmed())
        elif args.discard_untrimmed:
            yield self._both_sides_filter(IsUntrimmed(), untrimmed_mode)
        elif untrimmed_requested:
            yield self._filter_with_outputs(
                IsUntrimmed(),
                IsUntrimmed() if self._paired else None,
                args.untrimmed_output,
                args.untrimmed_paired_output,
                untrimmed_mode,
            )
        yield self._sink()

    def _demultiplexer(self, mode):
        args = self._args
        adapter_names = [a.name for a in self._adapters]
        adapter_names2 = [a.name for a in self._adapters2]
        if mode == "combinatorial":
            if args.pair_adapters:
                raise CommandLineError(
                    "With --pair-adapters, you can only use {name} in your output file name template, "
                    "not {name1} and {name2} (no combinatorial demultiplexing)."
                )
            if args.untrimmed_output or args.untrimmed_paired_output:
                raise CommandLineError(
                    "Combinatorial demultiplexing (with {name1} and {name2})"
                    " cannot be combined with --untrimmed-output or --untrimmed-paired-output"
                )
            return CombinatorialDemultiplexer(
                adapter_names,
                adapter_names2,
                template1=args.output,
                template2=args.paired_output,
                discard_untrimmed=args.discard_untrimmed,
                outfiles=self._outfiles,
            )
        if self._paired:
            return PairedDemultiplexer(
                adapter_names,
                template1=args.output,
                template2=args.paired_output,
                untrimmed_output=args.untrimmed_output,
                untrimmed_paired_output=args.untrimmed_paired_output,
                discard_untrimmed=args.discard_untrimmed,
                outfiles=self._outfiles,
            )
        return Demultiplexer(
            adapter_names,
            template=args.output,
            untrimmed_output=args.untrimmed_output,
            discard_untrimmed=args.discard_untrimmed,
            outfiles=self._outfiles,
        )

    def _sink(self):
        args = self._args
        if self._paired:
            if args.paired_output is None:
                writer = self._outfiles.open_record_writer(
                    args.output, interleaved=True
                )
            else:
                writer = self._outfiles.open_record_writer(
                    args.output, args.paired_output
                )
            return PairedEndSink(writer)
        if args.output is None:
            writer = self._outfiles.open_stdout_record_writer(
                interleaved=self._paired and args.interleaved,
                force_fasta=args.fasta,
            )
        else:
            writer = self._outfiles.open_record_writer(
                args.output, force_fasta=args.fasta
            )
        return SingleEndSink(writer)

    # modifiers --------------------------------------------------------

    def _for_both_sides(self, modifier):
        """Apply one single-end modifier to both reads of a pair."""
        if self._paired:
            return (modifier, copy.copy(modifier))
        return modifier

    def _modifiers(self):
        args, paired = self._args, self._paired
        yield from make_unconditional_cutters(args.cut, args.cut2, paired)
        if args.nextseq_trim is not None:
            yield self._for_both_sides(
                NextseqQualityTrimmer(args.nextseq_trim, args.quality_base)
            )
        yield from make_quality_trimmers(
            args.quality_cutoff, args.quality_cutoff2, args.quality_base, paired
        )
        yield from make_adapter_cutter(
            self._adapters,
            self._adapters2,
            paired,
            args.pair_adapters,
            None if args.action == "none" else args.action,
            args.times,
            args.reverse_complement,
            not args.rename,  # no "rc" suffix when --rename is in play
            args.index,
        )
        if args.poly_a:
            if paired:
                yield (PolyATrimmer(), PolyATrimmer(revcomp=True))
            else:
                yield PolyATrimmer()
        yield from make_shortener(args.length, args.length2, paired)
        for modifier in modifiers_applying_to_both_ends_if_paired(args):
            yield self._for_both_sides(modifier)
        if args.rename and (args.prefix or args.suffix):
            raise CommandLineError(
                "Option --rename cannot be combined with --prefix (-x) or --suffix (-y)"
            )
        if args.rename and args.rename != "{header}":
            try:
                yield (
                    PairedEndRenamer(args.rename)
                    if paired
                    else Renamer(args.rename)
                )
            except InvalidTemplate as e:
                raise CommandLineError(e)


def make_pipeline_from_args(
    args, input_file_format, outfiles, paired, adapters, adapters2
):
    """
    Set up a processing pipeline from parsed command-line arguments.
    Raise CommandLineError on any problem.
    """
    return PipelineBuilder(
        args, input_file_format, outfiles, paired, adapters, adapters2
    ).build()


def adapters_from_args(args) -> Tuple[List[Adapter], List[Adapter]]:
    search_parameters = dict(
        max_errors=args.error_rate,
        min_overlap=args.overlap,
        read_wildcards=args.match_read_wildcards,
        adapter_wildcards=args.match_adapter_wildcards,
        indels=args.indels,
    )
    try:
        adapters = make_adapters_from_specifications(args.adapters, search_parameters)
        adapters2 = make_adapters_from_specifications(
            args.adapters2, search_parameters
        )
    except (KeyError, ValueError, InvalidCharacter) as e:
        raise CommandLineError(e.args[0])
    warn_duplicate_adapters(adapters)
    warn_duplicate_adapters(adapters2)
    if args.debug > 1:
        for adapter in adapters + adapters2:
            adapter.enable_debug()
    return adapters, adapters2


def make_unconditional_cutters(cut1: List[int], cut2: List[int], paired: bool):
    for side, cut_arg in enumerate([cut1, cut2]):
        if not cut_arg:
            continue
        if len(cut_arg) > 2:
            raise CommandLineError("You cannot remove bases from more than two ends.")
        if len(cut_arg) == 2 and cut_arg[0] * cut_arg[1] > 0:
            raise CommandLineError("You cannot remove bases from the same end twice.")
        for c in cut_arg:
            if c == 0:
                continue
            if side == 0:  # R1
                yield (UnconditionalCutter(c), None) if paired else UnconditionalCutter(c)
            else:  # R2
                assert paired
                yield (None, UnconditionalCutter(c))


def make_quality_trimmers(
    cutoff1: Optional[str],
    cutoff2: Optional[str],
    quality_base: int,
    paired: bool,
):
    trimmers = [
        (
            QualityTrimmer(*parse_cutoffs(cutoff), quality_base)
            if cutoff is not None and cutoff != "0"
            else None
        )
        for cutoff in (cutoff1, cutoff2)
    ]
    if paired:
        if cutoff1 is not None and cutoff2 is None:
            trimmers[1] = copy.copy(trimmers[0])
        if trimmers != [None, None]:
            yield tuple(trimmers)
    elif trimmers[0] is not None:
        yield trimmers[0]


def make_adapter_cutter(
    adapters,
    adapters2,
    paired: bool,
    pair_adapters: bool,
    action: Optional[str],
    times: int,
    reverse_complement: bool,
    add_rc_suffix: bool,
    allow_index: bool,
):
    if pair_adapters:
        if reverse_complement:
            raise CommandLineError("Cannot use --revcomp with --pair-adapters")
        try:
            yield PairedAdapterCutter(adapters, adapters2, action)
        except PairedAdapterCutterError as e:
            raise CommandLineError("--pair-adapters: " + str(e))
        return
    rc_suffix = " rc" if add_rc_suffix else None
    try:
        cutter = AdapterCutter(adapters, times, action, allow_index) if adapters else None
        cutter2 = AdapterCutter(adapters2, times, action, allow_index) if adapters2 else None
    except ValueError as e:
        raise CommandLineError(e)
    if paired:
        if cutter or cutter2:
            if reverse_complement:
                yield PairedReverseComplementer(cutter, cutter2, rc_suffix=rc_suffix)
            else:
                yield (cutter, cutter2)
    elif cutter:
        if reverse_complement:
            yield ReverseComplementer(cutter, rc_suffix=rc_suffix)
        else:
            yield cutter


def make_shortener(length1: Optional[int], length2: Optional[int], paired: bool):
    if not paired:
        if length1 is not None:
            yield Shortener(length1)
        return
    if length1 is not None:
        # without -L, R2 gets the same setting as R1
        yield Shortener(length1), Shortener(length2 if length2 is not None else length1)
    elif length2 is not None:
        yield None, Shortener(length2)


def modifiers_applying_to_both_ends_if_paired(args) -> Iterator[SingleEndModifier]:
    if args.trim_n:
        yield NEndTrimmer()
    if args.length_tag:
        yield LengthTagModifier(args.length_tag)
    for suffix in args.strip_suffix:
        yield SuffixRemover(suffix)
    if args.prefix or args.suffix:
        yield PrefixSuffixAdder(args.prefix, args.suffix)
    if args.zero_cap:
        yield ZeroCapper(quality_base=args.quality_base)


# --- run orchestration -------------------------------------------------------


def log_header(cmdlineargs):
    """Print the program header."""
    implementation = platform.python_implementation()
    note = f" ({implementation})" if implementation != "CPython" else ""
    logger.info(
        "This is cutadapt-tpu-torch %s with Python %s%s",
        __version__,
        platform.python_version(),
        note,
    )
    logger.info("Command line parameters: %s", " ".join(cmdlineargs))


def log_adapters(adapters, adapters2):
    paired = adapters2 is not None
    logger.debug("R1 adapters (%d):" if paired else "Adapters (%d):", len(adapters))
    for a in itertools.islice(adapters, 20):
        logger.debug("- %s", a)
    if len(adapters) > 20:
        logger.debug("- (%d more)", len(adapters) - 20)
    if paired:
        logger.debug("R2 adapters (%d):", len(adapters2))
        for a in itertools.islice(adapters2, 20):
            logger.debug("- %s", a)
        if len(adapters2) > 20:
            logger.debug("- (%d more)", len(adapters2) - 20)


def setup_profiler_if_requested(requested):
    if not requested:
        return None
    import cProfile

    profiler = cProfile.Profile()
    profiler.enable()
    return profiler


def warn_if_en_dashes(args):
    for arg in args:
        if arg.startswith("–"):
            logger.warning(
                "The first character in argument '%s' is '–' (an en-dash, Unicode U+2013)"
                " and will therefore be interpreted as a file name. If you wanted to"
                " provide an option, use a regular hyphen '-'.",
                arg,
            )


def estimate_compression_threads(cores: int) -> Optional[int]:
    # at least one background thread: deflate then overlaps with the
    # device path's transfer waits even in single-core mode
    return min(max(cores - 1, 1), 4)


def is_any_output_stdout(args) -> bool:
    return args.output is None or "-" in (
        args.output,
        args.paired_output,
        args.untrimmed_output,
        args.untrimmed_paired_output,
        args.too_short_output,
        args.too_short_paired_output,
        args.too_long_output,
        args.too_long_paired_output,
        args.rest_file,
        args.info_file,
        args.wildcard_file,
    )


def json_report(
    stats: Statistics,
    cmdlineargs: List[str],
    path1: str,
    path2: Optional[str],
    cores: int,
    paired: bool,
    gc_content: float,
) -> Dict:
    d = {
        "tag": "Cutadapt report",
        "schema_version": OneLine([0, 3]),
        "cutadapt_version": __version__,
        "python_version": platform.python_version(),
        "command_line_arguments": cmdlineargs,
        "cores": cores,
        "input": {
            "path1": path1,
            "path2": path2,
            "paired": paired,
        },
    }
    d.update(stats.as_json(gc_content, one_line=True))
    return d


def _device_path_worth_trying(args, input_paths: InputPaths) -> bool:
    """Whether a multicore run should first be offered to the device
    engine: all inputs must be re-openable regular files and no output
    may be stdout (the parallel fallback re-reads the inputs and
    reopens every output, which must not close stdout mid-run)."""
    import os

    batch_env = os.environ.get("CUTADAPT_TPU_TORCH_BATCH")
    if batch_env == "0":
        return False
    if batch_env == "require":
        # strict mode: the engine either runs or errors — the fallback
        # safety conditions below protect a path that must not be taken
        return True
    if is_any_output_stdout(args):
        return False
    return all(
        path != "-" and Path(path).is_file() for path in input_paths.paths
    )


def _run_pipeline(args, cores, input_paths, file_opener, progress,
                  paired, adapters, adapters2):
    """Select a runner, build the pipeline, run it. Returns
    (statistics, outfiles)."""

    def build_outfiles_and_pipeline(runner, proxied):
        outfiles = OutputFiles(
            proxied=proxied,
            qualities=runner.input_file_format().has_qualities(),
            file_opener=file_opener,
            interleaved=args.interleaved,
        )
        pipeline = make_pipeline_from_args(
            args, runner.input_file_format(), outfiles, paired,
            adapters, adapters2,
        )
        return outfiles, pipeline

    if cores > 1 and _device_path_worth_trying(args, input_paths):
        # One GPU usually outruns N host workers: offer the run to the
        # batch engine first; on ineligibility fall back to processes.
        from .accel import try_run_accelerated

        runner = SerialPipelineRunner(input_paths.open())
        outfiles, pipeline = build_outfiles_and_pipeline(runner, proxied=False)
        stats = try_run_accelerated(pipeline, runner._infiles, progress)
        if stats is not None:
            return stats, outfiles
        runner.close()
        outfiles.close()

    with make_runner(input_paths, cores, args.buffer_size) as runner:
        outfiles, pipeline = build_outfiles_and_pipeline(
            runner, proxied=cores > 1
        )
        logger.info(
            "Processing %s reads on %d core%s ...",
            {False: "single-end", True: "paired-end"}[pipeline.paired],
            cores,
            "s" if cores > 1 else "",
        )
        stats = runner.run(pipeline, progress, outfiles)
    return stats, outfiles


def main_cli():  # pragma: no cover
    """Entry point for the command-line script."""
    multiprocessing.freeze_support()
    main(sys.argv[1:])
    return 0


def main(cmdlineargs) -> Statistics:
    """
    Set up a processing pipeline from the command-line arguments, run it
    and return a Statistics object. Traced, the whole call is a ``call``
    span.
    """
    span = tracing.begin_call()
    try:
        return _main(cmdlineargs)
    finally:
        tracing.end(span)


def _main(cmdlineargs) -> Statistics:
    start_time = time.time()
    parser = get_argument_parser()
    if not cmdlineargs:
        parser.print_usage()
        sys.exit(2)

    cmdlineargs = [str(arg) if isinstance(arg, Path) else arg for arg in cmdlineargs]
    args, leftover_args = parser.parse_known_args(args=cmdlineargs)
    # set up logging only if there are no handlers yet (this function
    # may be called from tests or as a library)
    if not logging.root.handlers:
        setup_logging(
            logger,
            log_to_stderr=is_any_output_stdout(args),
            quiet=args.quiet,
            minimal=args.report == "minimal",
            debug=args.debug,
        )
    log_header(cmdlineargs)
    profiler = setup_profiler_if_requested(args.profile)

    logger.debug("Python executable: %s", sys.executable)
    if args.quiet and args.report:
        parser.error("Options --quiet and --report cannot be used at the same time")
    if leftover_args:
        warn_if_en_dashes(cmdlineargs)
        parser.error("unrecognized arguments: " + " ".join(leftover_args))
    if args.cores < 0:
        parser.error("Value for --cores cannot be negative")

    cores = available_cpu_count() if args.cores == 0 else args.cores
    file_opener = FileOpener(
        compression_level=args.compression_level,
        threads=estimate_compression_threads(cores),
    )
    if sys.stderr.isatty() and not args.quiet and not args.debug:
        progress = Progress()
    else:
        progress = DummyProgress()
    paired = determine_paired(args)

    shard_env_prev = os.environ.get("CUTADAPT_TPU_TORCH_BYTE_RANGE")
    try:
        is_interleaved_input = args.interleaved and len(args.inputs) == 1
        input_paths = make_input_paths(args.inputs, paired, is_interleaved_input)
        _apply_shard_option(args, input_paths, is_interleaved_input)
        check_arguments(args, paired)
        adapters, adapters2 = adapters_from_args(args)
        log_adapters(adapters, adapters2 if paired else None)
        complain_about_duplicate_paths(
            [
                args.rest_file,
                args.info_file,
                args.wildcard_file,
                args.too_short_output,
                args.too_short_paired_output,
                args.too_long_output,
                args.too_long_paired_output,
                args.untrimmed_output,
                args.untrimmed_paired_output,
                args.output,
                args.paired_output,
            ]
        )
        stats, outfiles = _run_pipeline(
            args, cores, input_paths, file_opener, progress,
            paired, adapters, adapters2,
        )
    except KeyboardInterrupt:
        if args.debug:
            raise
        print("Interrupted", file=sys.stderr)
        sys.exit(130)
    except BrokenPipeError:
        sys.exit(1)
    except (
        OSError,
        EOFError,
        HasNoQualities,
        UnknownFileFormat,
        FileFormatError,
        CommandLineError,
        BatchRequiredError,
        DeviceError,
    ) as e:
        logger.debug("Command line error. Traceback:", exc_info=True)
        logger.error("%s", e)
        sys.exit(2 if isinstance(e, CommandLineError) else 1)
    finally:
        if args.shard:
            # restore the process env: main() may be called repeatedly
            # in one process (tests, library use)
            if shard_env_prev is None:
                os.environ.pop("CUTADAPT_TPU_TORCH_BYTE_RANGE", None)
            else:
                os.environ["CUTADAPT_TPU_TORCH_BYTE_RANGE"] = shard_env_prev
        try:
            outfiles.close()
        except UnboundLocalError:
            pass

    elapsed = time.time() - start_time
    stats_pickle = os.environ.get("CUTADAPT_TPU_TORCH_STATS_PICKLE")
    if stats_pickle is None and args.shard and args.output:
        # --shard runs always leave a mergeable statistics artifact for
        # the coordinator (parallel/multihost.merge_statistics)
        stats_pickle = f"{args.output}.shard-stats.pickle"
    if stats_pickle:
        # a shard run: pickle this process's Statistics for the merge
        # across processes (parallel/multihost.merge_statistics),
        # cutadapt's worker-pipe statistics protocol across processes.
        # They hold host objects only: the statistics reducer's device
        # bins were folded into numpy at the end of the drive.
        import pickle

        with open(stats_pickle, "wb") as f:
            pickle.dump(stats, f)
    render = minimal_report if args.report == "minimal" else full_report
    logger.log(REPORT, "%s", render(stats, elapsed, args.gc_content / 100.0))
    if args.json is not None:
        with open(args.json, "w") as f:
            f.write(
                json_dumps(
                    json_report(
                        stats=stats,
                        cmdlineargs=cmdlineargs,
                        path1=input_paths.paths[0],
                        path2=(
                            input_paths.paths[1]
                            if len(input_paths.paths) > 1
                            else None
                        ),
                        cores=cores,
                        paired=paired,
                        gc_content=args.gc_content / 100.0,
                    )
                )
            )
            f.write("\n")
    if profiler is not None:
        import pstats

        profiler.disable()
        pstats.Stats(profiler).sort_stats("time").print_stats(20)
    return stats


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main_cli())

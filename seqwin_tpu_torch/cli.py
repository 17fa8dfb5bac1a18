"""Command-line interface: ``python -m seqwin_tpu_torch``.

Counterpart: `seqwin_tpu/cli.py`, with the same option surface (flags,
dests, defaults, choices), implemented with argparse. Flag inversions
preserved: --no-mash -> run_mash=False, --no-blast -> run_blast=False,
--no-gzip -> gzip=False. The run goes to the GPU, ``--low-memory`` with
smaller chunks (2^22 bases; longer records in halo'd blocks), ``--sketch-mode
device`` with MinHash sketches on the card. Without a GPU it stops with a
message and exit code 1. ``--backend numpy|oracle`` builds the graph (and
computes any sketches) on the host and runs without a GPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ._version import __version__

PROG = 'seqwin-tpu-torch'


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description='seqwin-tpu-torch: identification of signature sequences on an NVIDIA GPU',
        add_help=False,
    )
    g_in = p.add_argument_group('Input selection')
    g_in.add_argument('--tar-taxa', '-t', action='append', default=None, metavar='TEXT',
                      help='Target NCBI taxonomy name or ID (repeatable).')
    g_in.add_argument('--neg-taxa', '-n', action='append', default=None, metavar='TEXT',
                      help='Non-target NCBI taxonomy name or ID (repeatable).')
    g_in.add_argument('--tar-paths', type=Path, default=None,
                      help='Text file with paths to target genome FASTA files, one per line.')
    g_in.add_argument('--neg-paths', type=Path, default=None,
                      help='Text file with paths to non-target genome FASTA files.')
    g_in.add_argument('--tar-dir', type=Path, default=None,
                      help='Directory containing target genome FASTA files.')
    g_in.add_argument('--neg-dir', type=Path, default=None,
                      help='Directory containing non-target genome FASTA files.')

    g_out = p.add_argument_group('Output options')
    g_out.add_argument('--prefix', type=Path, default=Path.cwd(),
                       help='Parent path for the output directory (default: cwd).')
    g_out.add_argument('--title', '-o', default='seqwin-out',
                       help='Name of the output directory created under --prefix.')
    g_out.add_argument('--overwrite', action='store_true', help='Overwrite existing output files.')

    g_sig = p.add_argument_group('Signature options')
    g_sig.add_argument('--kmerlen', '-k', type=int, default=21, help='K-mer length.')
    g_sig.add_argument('--windowsize', '-w', type=int, default=200, help='Minimizer window size.')
    g_sig.add_argument('--penalty-th', type=float, default=None,
                       help='Node penalty threshold [0,1]; auto-computed if omitted.')
    g_sig.add_argument('--no-mash', action='store_true',
                       help='Estimate penalty threshold from minimizer sketches instead of Mash.')
    g_sig.add_argument('--stringency', '-s', type=int, default=5,
                       help='Sensitivity/specificity control (0-10).')
    g_sig.add_argument('--min-len', type=int, default=200, help='Minimum signature length.')
    g_sig.add_argument('--max-len', type=int, default=None, help='Estimated maximum signature length.')
    g_sig.add_argument('--no-blast', action='store_true', help='Skip BLAST evaluation.')
    g_sig.add_argument('--no-filter', action='store_true', help=argparse.SUPPRESS)

    g_ncbi = p.add_argument_group('NCBI download options')
    g_ncbi.add_argument('--level', default='contig', metavar='TEXT',
                        help="Min assembly level: 'contig', 'scaffold', 'chromosome', 'complete'.")
    g_ncbi.add_argument('--source', default='genbank', metavar='TEXT',
                        help="Genome source: 'genbank' or 'refseq'.")
    g_ncbi.add_argument('--annotated', action='store_true', help='Only include annotated genomes.')
    g_ncbi.add_argument('--exclude-mag', action='store_true', help='Exclude MAGs.')
    g_ncbi.add_argument('--no-gzip', action='store_true', help='Do not download gzipped FASTA.')
    g_ncbi.add_argument('--api-key', default=None, help='NCBI API key.')
    g_ncbi.add_argument('--download-only', action='store_true',
                        help='Only download genomes, do not run the pipeline.')

    g_misc = p.add_argument_group('Miscellaneous')
    g_misc.add_argument('--seed', type=int, default=42, help='Random seed.')
    g_misc.add_argument('--threads', '-p', dest='n_cpu', type=int, default=4,
                        help='Number of parallel host processes/threads.')
    g_misc.add_argument('--low-memory', action='store_true',
                        help='Reduce peak memory (smaller device chunks).')
    g_misc.add_argument('--backend', default='auto',
                        choices=('auto', 'xla', 'numpy', 'oracle'),
                        help='Compute backend for the graph build (auto and xla: the '
                             'GPU build; numpy and oracle: host references, no GPU '
                             'needed).')
    g_misc.add_argument('--devices', type=int, default=1,
                        help='GPUs for the graph build: 0 = every card, 1 = one card, '
                             'N>1 = N cards.')
    g_misc.add_argument('--sketch-mode', default='auto',
                        choices=('auto', 'device', 'minimizer'),
                        help='Jaccard estimator for the penalty threshold '
                             '(device = on-device bottom-k MinHash).')
    g_misc.add_argument('--seed-pattern', default=None,
                        help="Spaced-seed pattern ('1'/'0' string) for the "
                             'on-device sketches; default contiguous k-mers.')
    g_misc.add_argument('--version', action='version', version=f'{PROG} v{__version__}',
                        help='Show version and exit.')
    g_misc.add_argument('--help', '-h', action='help', help='Show this message and exit.')
    return p


def config_from_args(args: argparse.Namespace):
    """The `Config` of parsed arguments."""
    from .config import Config

    return Config(
        tar_taxa=args.tar_taxa,
        neg_taxa=args.neg_taxa,
        tar_paths=args.tar_paths,
        neg_paths=args.neg_paths,
        tar_dir=args.tar_dir,
        neg_dir=args.neg_dir,
        prefix=args.prefix,
        title=args.title,
        overwrite=args.overwrite,
        kmerlen=args.kmerlen,
        windowsize=args.windowsize,
        penalty_th=args.penalty_th,
        run_mash=not args.no_mash,
        stringency=args.stringency,
        min_len=args.min_len,
        max_len=args.max_len,
        run_blast=not args.no_blast,
        no_filter=args.no_filter,
        level=args.level,
        source=args.source,
        annotated=args.annotated,
        exclude_mag=args.exclude_mag,
        gzip=not args.no_gzip,
        api_key=args.api_key,
        download_only=args.download_only,
        seed=args.seed,
        n_cpu=args.n_cpu,
        low_memory=args.low_memory,
        device_backend=args.backend,
        devices=args.devices,
        sketch_mode=args.sketch_mode,
        seed_pattern=args.seed_pattern,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if not args.download_only:
        if (args.tar_paths is None) and (args.tar_taxa is None) and (args.tar_dir is None):
            print('You must provide at least one target input: --tar-paths, --tar-taxa, or --tar-dir', file=sys.stderr)
            return 2
        elif (args.neg_paths is None) and (args.neg_taxa is None) and (args.neg_dir is None):
            print('You must provide at least one non-target input: --neg-paths, --neg-taxa, or --neg-dir', file=sys.stderr)
            return 2

    from .core import run
    from .device import DeviceUnavailable

    try:
        run(config_from_args(args))
    except DeviceUnavailable as e:
        print(f'{PROG}: {e}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())

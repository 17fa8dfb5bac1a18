"""NCBI adapters: genome acquisition via the `datasets` CLI, candidate
evaluation via BLAST+.

Counterpart: `seqwin_tpu/ncbi.py` (a copy, but for `blast()`, which parses
the ``-outfmt 6`` table itself into numpy columns instead of a DataFrame).
Same external-tool protocol as the reference: dehydrated taxon downloads
that are rehydrated in place and reused across runs, and batched `blastn`
over stdin.
"""
from __future__ import annotations

import json
import logging
import math
import shutil
import zipfile
from collections.abc import Sequence
from enum import Enum
from pathlib import Path

import numpy as np

from .utils import claim_file, fail, list_dir, run_tool

logger = logging.getLogger(__name__)

_ZIP_EXT = '.zip'
_BLAST_COL = (
    'qseqid', 'sseqid', 'length', 'pident', 'nident', 'mismatch', 'gapopen',
    'gaps', 'qstart', 'qend', 'sstart', 'send', 'evalue', 'bitscore', 'qseq', 'sseq',
)
_MAX_REHYDRATE_WORKERS = 8
_BLAST_LIMITS = ('-max_hsps', '1000', '-max_target_seqs', '50000')

#: fields that `pandas.read_csv` reads as missing by default
_NA_TOKENS = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan', '1.#IND',
    '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a', 'nan', 'null',
))

#: a table of equal-length numpy columns, in column order
Table = dict[str, np.ndarray]


class Format(str, Enum):
    fasta = 'fasta'
    genbank = 'genbank'


class Level(str, Enum):
    contig = 'contig'
    scaffold = 'scaffold'
    chromosome = 'chromosome'
    complete = 'complete'


class Source(str, Enum):
    genbank = 'genbank'
    refseq = 'refseq'


class Task(str, Enum):
    blastn = 'blastn'
    blastn_short = 'blastn-short'
    megablast = 'megablast'


#: `datasets --assembly-level` accepts a minimum level as a cumulative list
_LEVEL_FLAGS = {
    Level.scaffold: 'scaffold,chromosome,complete',
    Level.chromosome: 'chromosome,complete',
    Level.complete: 'complete',
}


def _datasets(*args: str | Path, api_key: str | None, check: bool = False):
    """Invoke the NCBI `datasets` CLI, appending the API key when given."""
    argv = list(args)
    if api_key is not None:
        argv += ['--api-key', api_key]
    return run_tool(*argv, check=check)


def search_taxon(taxon: str, api_key: str | None = None) -> tuple[str | None, str | None]:
    """Resolve a taxon name/id via `datasets summary taxonomy`."""
    logger.info(f'Searching NCBI Taxonomy for "{taxon}"...')
    summary = _datasets(
        'datasets', 'summary', 'taxonomy', 'taxon', str(taxon),
        '--as-json-lines', '--report', 'names',
        api_key=api_key,
    )
    if not summary.stdout:
        logger.error(summary.stderr)
        logger.error(f' - Unable to find taxon "{taxon}"')
        return None, None
    taxonomy = json.loads(summary.stdout)['taxonomy']
    tax_id = taxonomy['tax_id']
    logger.info(f' - Found NCBI Taxonomy ID: {tax_id}')
    return tax_id, taxonomy['current_scientific_name']['name']


def get_assembly_paths(package_dir: Path) -> list[Path]:
    """One FASTA per `ncbi_dataset/data/<accession>/` subdirectory."""
    if not package_dir.is_dir():
        fail(NotADirectoryError, f'Not a directory: {package_dir}')
    found: list[Path] = []
    for accession_dir in list_dir(package_dir / 'ncbi_dataset' / 'data', mode='d'):
        files = list_dir(accession_dir, mode='f')
        if not files:
            fail(FileNotFoundError, f'No assembly file is found {accession_dir}')
        if len(files) > 1:
            logger.warning(f' - Found more than one files under {accession_dir}')
        found.append(files[0])
    return found


def _reuse_package(tax_dir: Path) -> list[Path]:
    logger.warning(f'Existing genome package is found {tax_dir}')
    try:
        paths = get_assembly_paths(tax_dir)
    except Exception as e:
        fail(
            RuntimeError,
            f'Genome package might be incomplete {tax_dir}\nConsider deleting it and try again',
            cause=e,
        )
    logger.info(f' - Found {len(paths)} genome assemblies.')
    return paths


def _download_args(
    tax_id: str, tax_zip: Path, format: Format, level: Level, source: Source,
    annotated: bool, exclude_mag: bool,
) -> list:
    argv = [
        'datasets', 'download', 'genome', 'taxon', tax_id,
        '--filename', tax_zip,
        '--exclude-atypical', '--exclude-multi-isolate',
        '--no-progressbar', '--dehydrated',
        '--include', 'genome' if format == Format.fasta else 'gbff',
    ]
    min_level = _LEVEL_FLAGS.get(level)
    if min_level:
        argv += ['--assembly-level', min_level]
    argv += ['--assembly-source', 'GenBank' if source == Source.genbank else 'RefSeq']
    if annotated:
        argv.append('--annotated')
    argv += ['--mag', 'exclude' if exclude_mag else 'all']
    return argv


def download_taxon(
    taxon: str,
    prefix: Path = Path.cwd(),
    format: Format = Format.fasta,
    level: Level = Level.contig,
    source: Source = Source.genbank,
    annotated: bool = True,
    exclude_mag: bool = False,
    gzip: bool = True,
    api_key: str | None = None,
    overwrite: bool = False,
    n_cpu: int = 1,
) -> list[Path] | None:
    """Dehydrated download + rehydrate of all assemblies under a taxon.

    Existing package directories are reused (resumable acquisition); failed
    downloads are cleaned up so a retry starts fresh.
    """
    if not prefix.is_dir():
        fail(NotADirectoryError, f'Cannot download genomes to this location, since it is not a directory: {prefix}')

    tax_dir = prefix / taxon.replace(' ', '-')
    if tax_dir.exists():
        return _reuse_package(tax_dir)

    tax_id, tax_name = search_taxon(taxon, api_key=api_key)
    if tax_id is None:
        return None
    tax_dir = prefix / tax_name.replace(' ', '-')
    tax_zip = tax_dir.with_name(tax_dir.name + _ZIP_EXT)
    claim_file(tax_zip, overwrite=overwrite)

    logger.info(f'Downloading genome package for NCBI Taxonomy ID {tax_id}...')
    dl = _datasets(
        *_download_args(tax_id, tax_zip, format, level, source, annotated, exclude_mag),
        api_key=api_key,
    )
    if dl.returncode != 0:
        logger.error(dl.stderr)
        logger.error(f' - No genome assemblies were found for NCBI Taxonomy ID {tax_id}, try loosen the filters.')
        return None

    try:
        with zipfile.ZipFile(tax_zip, 'r') as zf:
            zf.extractall(tax_dir)
    except Exception as e:
        shutil.rmtree(tax_dir)
        fail(RuntimeError, f'Failed to unzip genome package for NCBI Taxonomy ID {tax_id}: {tax_zip}', cause=e)

    rehydrate = [
        'datasets', 'rehydrate', '--directory', tax_dir,
        '--max-workers', str(min(n_cpu, _MAX_REHYDRATE_WORKERS)),
        '--no-progressbar',
    ]
    if gzip:
        rehydrate.append('--gzip')
    try:
        _datasets(*rehydrate, api_key=api_key, check=True)
    except Exception as e:
        shutil.rmtree(tax_dir)
        fail(
            RuntimeError,
            (f'Failed to rehydrate data package for taxon "{taxon}".\n'
             'NCBI might have blocked the request due to high usage. Try waiting before retrying.\n'
             'Add --overwrite so downloaded taxon packages can be reused.'),
            cause=e,
        )
    paths = get_assembly_paths(tax_dir)
    logger.info(f' - Downloaded {len(paths)} genome assemblies for NCBI Taxonomy ID {tax_id}.')
    return paths


def _tsv_column(fields: list[str]) -> np.ndarray:
    """One column with the dtype `pandas.read_csv` infers: int64 when every
    field is an integer, else float64 when every field is a number or
    missing (NaN), else object (str, NaN where missing). Floats are read
    correctly rounded; pandas' parser can differ by an ulp on tiny e-values,
    which reach no output file."""
    if not fields:
        return np.empty(0, dtype=object)
    na = [f in _NA_TOKENS for f in fields]
    if not any(na):
        try:
            return np.array(fields).astype(np.int64)
        except ValueError:
            pass
    try:
        return np.array([math.nan if m else float(f) for f, m in zip(fields, na)],
                        dtype=np.float64)
    except ValueError:
        return np.array([math.nan if m else f for f, m in zip(fields, na)], dtype=object)


def read_tsv(text: str, columns: Sequence[str]) -> Table:
    """Header-less tab-separated ``text`` as numpy columns named ``columns``
    (`pandas.read_csv(sep='\\t', header=None, names=columns,
    index_col=False)` without pandas)."""
    rows = [line.split('\t') for line in text.splitlines() if line]
    if any(len(r) != len(columns) for r in rows):
        fail(ValueError, f'Expected {len(columns)} tab-separated fields per BLAST output line')
    cols = list(zip(*rows)) if rows else [()] * len(columns)
    return {name: _tsv_column(list(col)) for name, col in zip(columns, cols)}


def blast(
    seq_list: Sequence[str],
    db: Path,
    task: Task = Task.blastn,
    columns: Sequence[str] | None = None,
    taxids: Sequence[int] | None = None,
    neg_taxids: Sequence[int] | None = None,
    n_cpu: int = 1,
    batch_size: int = 1000,
) -> Table:
    """Batched blastn over stdin; qseqid = 0-based index into ``seq_list``."""
    if not seq_list:
        fail(ValueError, 'No input sequence provided for BLAST')
    if columns is None:
        columns = _BLAST_COL

    argv = [
        'blastn', '-db', db, '-task', task,
        '-outfmt', f'6 {" ".join(columns)}',
        *_BLAST_LIMITS,
        '-num_threads', str(n_cpu),
    ]
    if taxids is not None:
        argv += ['-taxids', ','.join(map(str, taxids))]
    if neg_taxids is not None:
        argv += ['-negative_taxids', ','.join(map(str, neg_taxids))]

    total = len(seq_list)
    logger.info(f' - Running blastn on {total} sequences, with batch size of {batch_size} (threads={n_cpu})...')
    tables: list[Table] = []
    for lo in range(0, total, batch_size):
        logger.info(f' - {lo}/{total}')
        stdin = ''.join(
            f'>{i}\n{seq_list[i]}\n' for i in range(lo, min(lo + batch_size, total))
        )
        tables.append(read_tsv(run_tool(*argv, stdin=stdin).stdout, columns))
    if len(tables) == 1:
        return tables[0]
    return {c: np.concatenate([t[c] for t in tables]) for c in columns}

"""Run configuration, runtime state, and output-file registry.

Counterpart: `seqwin_tpu/config.py`, without pydantic: `Config` is a frozen,
slotted dataclass with the same fields, defaults, path resolution,
validators, error types and messages, and a `model_dump_json` that writes
the same `config.json`. One field is the port's own: ``device`` (None = the
GPU; the JAX package picks its platform with ``JAX_PLATFORMS``), which the
CLI does not set and `config.json` leaves out.
"""
from __future__ import annotations

import json
import logging
import shutil
import sys
from collections.abc import Mapping
from dataclasses import dataclass, field, fields
from enum import Enum
from pathlib import Path
from random import Random
from types import MappingProxyType

_LOG_FMT = '%(asctime)s | %(levelname)-8s | %(message)s'
_LOG_DATEFMT = '%Y-%m-%d %H:%M:%S'

logging.basicConfig(
    format=_LOG_FMT,
    datefmt=_LOG_DATEFMT,
    level=logging.INFO,
    stream=sys.stdout,
)

from ._version import __version__  # noqa: E402
from .ncbi import Level, Source, Task  # noqa: E402

HAS_MASH = shutil.which('mash') is not None
HAS_BLAST = (shutil.which('makeblastdb') is not None) and (shutil.which('blastn') is not None)
HAS_DATASETS = shutil.which('datasets') is not None

# path field -> (must-exist predicate, noun for the error message)
_PATH_KINDS: dict[str, tuple[str, str]] = {
    'tar_paths': ('is_file', 'file'),
    'neg_paths': ('is_file', 'file'),
    'tar_dir': ('is_dir', 'directory'),
    'neg_dir': ('is_dir', 'directory'),
    'prefix': ('is_dir', 'directory'),
}
# any-of-these-required input groups, by role
_INPUT_GROUPS = (
    ('target', ('tar_paths', 'tar_taxa', 'tar_dir')),
    ('non-target', ('neg_paths', 'neg_taxa', 'neg_dir')),
)
_ENUMS = {'level': Level, 'source': Source}
_FLOATS = ('penalty_th', 'penalty_th_cap', 'edge_w_th_mul')


class SecretStr:
    """A string that prints and serializes masked."""

    __slots__ = ('_secret',)

    def __init__(self, secret: str) -> None:
        self._secret = secret

    def get_secret_value(self) -> str:
        return self._secret

    def __str__(self) -> str:
        return '**********' if self._secret else ''

    def __repr__(self) -> str:
        return f"SecretStr('{self}')"

    def __eq__(self, other) -> bool:
        return isinstance(other, SecretStr) and other._secret == self._secret


def _resolve_path(name: str, v) -> Path:
    try:
        path = Path(v).expanduser().resolve(strict=True)
    except OSError:
        raise ValueError(f'Path does not exist or cannot be resolved: {v!r}')
    predicate, noun = _PATH_KINDS[name]
    if not getattr(path, predicate)():
        raise ValueError(f'Not a {noun}: {path}')
    return path


def _json_value(v):
    if isinstance(v, Enum):
        return v.value
    if isinstance(v, (Path, SecretStr)):
        return str(v)
    return v


@dataclass(frozen=True, slots=True)
class Config:
    """Run configuration (field meanings as in the reference's Config)."""

    # Inputs
    tar_taxa: list[str] | None = None
    neg_taxa: list[str] | None = None
    tar_paths: Path | None = None
    neg_paths: Path | None = None
    tar_dir: Path | None = None
    neg_dir: Path | None = None

    # Outputs
    prefix: Path = field(default_factory=Path.cwd)
    title: str = 'seqwin-out'
    overwrite: bool = False

    # Signature options
    kmerlen: int = 21
    windowsize: int = 200
    penalty_th: float | None = None
    run_mash: bool = True
    stringency: int = 5
    min_len: int = 200
    max_len: int | None = None
    run_blast: bool = True
    no_filter: bool = False
    blast_neg_only: bool = False

    # Graph filtering options (not included in CLI)
    penalty_th_cap: float = 0.2
    edge_w_th_mul: float = 0.3
    min_nodes_floor: int = 3
    max_nodes_cap: int | None = 100

    # Mash / sketch parameters (not included in CLI)
    sketchsize: int = 1000

    # NCBI download options
    level: Level = Level.contig
    source: Source = Source.genbank
    annotated: bool = False
    exclude_mag: bool = False
    gzip: bool = True
    api_key: SecretStr | None = None
    download_only: bool = False

    # Miscellaneous
    seed: int = 42
    n_cpu: int = 4
    low_memory: bool = False

    # Additive knobs of the JAX package (defaults keep reference behavior)
    device_backend: str = 'auto'  # 'auto' | 'xla' | 'numpy' | 'oracle'
    # Jaccard estimator for the penalty threshold: 'auto' (mash when
    # run_mash and installed, else minimizer sketches), 'device' (MinHash
    # sketches on the run's device), 'minimizer'
    sketch_mode: str = 'auto'
    # Spaced-seed pattern for the device sketches; None = contiguous k-mers
    seed_pattern: str | None = None
    # Devices of the graph build: 0 = every card, 1 = one, N > 1 = N cards
    devices: int = 1
    # When set, capture a torch.profiler trace of the run into this directory
    profile_dir: Path | None = None

    # The port's own: the torch device of the run, None = the GPU
    device: str | None = None

    def __post_init__(self) -> None:
        for name in _PATH_KINDS:
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, _resolve_path(name, v))
        for name, enum in _ENUMS.items():
            object.__setattr__(self, name, enum(getattr(self, name)))
        for name in _FLOATS:
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, float(v))
        if self.api_key is not None and not isinstance(self.api_key, SecretStr):
            object.__setattr__(self, 'api_key', SecretStr(self.api_key))
        if self.profile_dir is not None:
            object.__setattr__(self, 'profile_dir', Path(self.profile_dir))
        self._check_inputs()

    @property
    def version(self) -> str:
        return __version__

    def _check_inputs(self) -> None:
        wants_download = self.tar_taxa or self.neg_taxa
        if wants_download and not HAS_DATASETS:
            raise FileNotFoundError(
                'ncbi-datasets-cli is not installed. Genomes cannot be downloaded from the '
                'provided taxon names or IDs. Please provide local files instead'
            )
        if not self.download_only:
            for role, names in _INPUT_GROUPS:
                if all(getattr(self, f) is None for f in names):
                    raise ValueError(
                        f'You must provide at least one {role} input: '
                        + ', '.join(names[:-1]) + f', or {names[-1]}')
        for name, lo_c, hi_c in (('penalty_th', 0, 1), ('stringency', 0, 10)):
            val = getattr(self, name)
            if val is not None and not lo_c <= val <= hi_c:
                raise ValueError(f'{name} must be between [{lo_c}, {hi_c}]')
        if (self.max_len is not None) and (self.max_len <= self.min_len):
            raise ValueError('max_len must be greater than min_len')
        if self.seed_pattern is not None:
            # the one validator (also warns on non-palindromic patterns)
            from .ops.spaced import parse_seed

            parse_seed(self.seed_pattern)
        if self.devices < 0:
            raise ValueError('devices must be >= 0 (0 = all local devices)')

    def model_dump_json(self, indent: int | None = None) -> str:
        """The JSON the JAX package's pydantic Config writes: every field in
        order (enums as values, paths as strings, the API key masked), then
        ``version``."""
        data = {f.name: _json_value(getattr(self, f.name))
                for f in fields(self) if f.name != 'device'}
        data['version'] = self.version
        separators = None if indent is not None else (',', ':')
        return json.dumps(data, indent=indent, separators=separators, ensure_ascii=False)


@dataclass(slots=True)
class RunState:
    """Mutable runtime derivations of a run."""

    working_dir: Path
    rng: Random
    n_tar: int | None = None
    n_neg: int | None = None
    penalty_th: float | None = None
    edge_weight_th: float | None = None
    min_nodes: int | None = None
    max_nodes: int | None = None
    blastdb: Path | None = None


@dataclass(slots=True, frozen=True)
class WorkingDir:
    """File names under the working directory."""

    log: str = 'seqwin.log'
    config: str = 'config.json'
    assemblies_dir: str = 'assemblies'
    assemblies_csv: str = 'assemblies.csv'
    graph: str = 'graph.npz'
    mash: str = 'sketches'
    blast_dir: str = 'blastdb'
    blast_log: str = 'makeblastdb.log'
    markers_fasta: str = 'signatures.fasta'
    markers_csv: str = 'signatures.csv'
    results: str = 'results.seqwin'


@dataclass(slots=True, frozen=True)
class BlastConfig:
    """Settings for `makeblastdb` / `blastn` adapters."""

    title_neg_only: str = 'neg-only'
    title_all: str = 'all'
    queue_size: int = 50
    bool2str: Mapping[bool, str] = field(
        default_factory=lambda: MappingProxyType({True: 'y', False: 'n'})
    )
    str2bool: Mapping[str, bool] = field(
        default_factory=lambda: MappingProxyType({'y': True, 'n': False})
    )
    header_sep: str = '@'
    task: Task = Task.blastn
    columns = (
        'qseqid',
        'sseqid',
        'nident',
        'mismatch',
        'gaps',
        'qstart',
        'qend',
        'sstart',
        'send',
        'evalue',
        'bitscore',
        'sseq',
    )
    batch_size: int = 1000


def config_logger(file: Path, level: int) -> None:
    """Attach a file handler to the root logger."""
    formatter = logging.Formatter(fmt=_LOG_FMT, datefmt=_LOG_DATEFMT, style='%')
    handler = logging.FileHandler(file, mode='a')
    handler.setFormatter(formatter)
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(level)


WORKINGDIR = WorkingDir()
BLASTCONFIG = BlastConfig()

EDGE_W: str = 'w'
NODE_P: str = 'p'
CONSEC_KMER_MUL: float = 1.5
NO_BLAST_DIV: float = 0.5

"""K-mer graph construction, penalty scoring, and filtering.

Counterpart: `seqwin_tpu/pipeline/kmers.py`. Host orchestration over the
port's build (`graph.build_deferred` on the card, kernel B1; with
``devices`` above one the multi-device build, kernels B2 and B3; with
``backend='numpy'|'oracle'`` the host build). The
penalty formula, threshold estimation and filtering order follow the
reference, in float64 host math. ``sketch_mode='device'`` estimates the
threshold from MinHash sketches computed on the run's device (`mash.py`).

After `KmerGraph.filter()` the instance holds numpy arrays only: the device
handle is released, so the forked marker workers never meet a tensor and
the pickled run holds none.

Spans (`engine/timeline.py`): ``phase.build_graph``, ``phase.threshold``
(with ``threshold.sketches`` around the device sketches, its ``bases``
hashed and ``h2d_bytes`` copied, separators included, on a card the cut's
``candidates`` and ``fallbacks`` (`mash.py`), and
``threshold.jaccard`` around their Jaccard matrix, its ``pairs`` and
``blocks``) and ``phase.subgraphs`` (with ``subgraphs.edges``, the edge
filter and the adjacency, ``subgraphs.search`` and ``subgraphs.compact``,
the kept k-mers), each phase over the interval its ``Finished in`` timer
measures.
"""
from __future__ import annotations

import logging
from random import Random
from time import time

import numpy as np
from numpy.typing import NDArray

from ..assemblies import Assemblies
from ..config import HAS_MASH, WORKINGDIR, Config, RunState
from ..engine import timeline
from ..engine.aggregate import HostGraph
from ..graph import HashGraph
from ..graph.build import build_deferred, kept_node_layout
from ..io.fasta import iter_assemblies
from ..mash import device_sketches, pair_block, sketch_jaccard_matrix, stream_bases
from ..utils import log_elapsed
from .subgraphs import get_subgraphs

logger = logging.getLogger(__name__)


class KmerGraph:
    """Minimizer graph with penalties; filter() extracts low-penalty subgraphs.

    Attributes mirror the reference: kmers / nodes / edges structured
    arrays, record_offsets, graph (adjacency), subgraphs.
    """

    __slots__ = (
        '_kmers', 'nodes', '_edges', 'record_offsets', 'graph', 'node_penalty',
        'subgraphs', '_is_filtered', '_graph',
    )

    def __init__(
        self,
        assemblies: Assemblies,
        kmerlen: int,
        windowsize: int,
        n_cpu: int,
        low_memory: bool,
        backend: str = 'auto',
        keep_codes: bool = False,
        devices: int = 1,
        device=None,
    ) -> None:
        n_assemblies = len(assemblies)
        logger.info(f'Building minimizer graph from {n_assemblies} assemblies...')
        if low_memory:
            logger.warning(' - Low-memory mode is enabled; graph construction may take longer.')
        with timeline.span('phase.build_graph'):
            tik = time()

            # deferred build: nodes land on the host (penalty/threshold math
            # below is float64 host work); the k-mer stream and edges stay on
            # the device until filter()/materialize() knows which entries are
            # needed
            graph, record_offsets, record_ids = build_deferred(
                assemblies.path,
                kmerlen,
                windowsize,
                assemblies.is_target,
                n_cpu=n_cpu,
                low_memory=low_memory,
                backend=backend,
                keep_codes=keep_codes,
                devices=devices,
                device=device,
            )
            nodes = graph.nodes
            n_tar = sum(assemblies.is_target)
            n_neg = n_assemblies - n_tar
            nodes['penalty'] = frac_to_penalty(
                nodes['n_tar'] / n_tar,
                nodes['n_neg'] / n_neg,
            )
            assemblies.record_ids = record_ids

            dt = time() - tik
        logger.info(f' - Found {graph.n_kmers} minimizers')
        logger.info(f' - Found {len(nodes)} nodes (unique minimizers)')
        logger.info(f' - Found {graph.n_edges} weighted edges')
        if dt > 0:
            logger.info(
                f' - Throughput: {graph.n_kmers / dt:,.0f} minimizers/s, '
                f'{n_assemblies / dt:,.2f} genomes/s'
            )
        log_elapsed(dt)

        self.kmers = None
        self.nodes = nodes
        self.edges = None
        self.record_offsets = record_offsets
        self.graph = None
        self.node_penalty = None
        self.subgraphs = None
        self._is_filtered = False
        self._graph = graph

    @property
    def kmers(self) -> NDArray | None:
        """Full KMER_DTYPE array. While the build is deferred (the stream on
        the device, see `build_deferred`) the first access materializes it."""
        if self._kmers is None and getattr(self, '_graph', None) is not None:
            self.materialize()
        return self._kmers

    @kmers.setter
    def kmers(self, value) -> None:
        self._kmers = value

    @property
    def edges(self) -> NDArray | None:
        """Full EDGE_DTYPE array; lazily materialized like `kmers`."""
        if self._edges is None and getattr(self, '_graph', None) is not None:
            self.materialize()
        return self._edges

    @edges.setter
    def edges(self, value) -> None:
        self._edges = value

    def materialize(self) -> None:
        """Transfer the full kmers/edges arrays to the host (the
        `--no-filter` path and library users that want the raw graph)."""
        graph = getattr(self, '_graph', None)
        if graph is not None:
            self.kmers, self.edges = graph.materialize()
            graph.release()
            self._graph = None

    def filter(
        self,
        penalty_th: float,
        edge_weight_th: float,
        min_nodes: int,
        max_nodes: int | None,
        rng: Random,
    ) -> None:
        """Remove low-weight edges / isolated nodes, extract subgraphs, and
        compact the k-mer arrays to the used nodes."""
        if self._is_filtered:
            logger.error('K-mers are already filtered, cannot filter again.')
            return None

        logger.info('Extracting low-penalty subgraphs from the k-mer graph...')
        with timeline.span('phase.subgraphs'):
            tik = time()
            if max_nodes is None:
                logger.warning(f' - Upper limit of subgraph size is not set. Lower limit is set to {min_nodes}')
            else:
                logger.info(f' - Subgraph size limit is set to [{min_nodes}, {max_nodes}]')

            handle = getattr(self, '_graph', None)
            if handle is None:
                # host-array instances (tests / loaded results)
                handle = HostGraph(self.kmers, self.nodes, self.edges)

            with timeline.span('subgraphs.edges'):
                nodes, edges, graph, node_penalty = KmerGraph.__filter_graph(
                    self.nodes, handle, edge_weight_th
                )
            with timeline.span('subgraphs.search'):
                subgraphs, used_hashes = get_subgraphs(
                    graph, node_penalty, penalty_th, min_nodes, max_nodes, rng
                )

            logger.info(' - Removing k-mers not included in any of the subgraphs...')
            with timeline.span('subgraphs.compact'):
                # keep flags over the FULL node array (aligned with the
                # device stream); used_hashes only holds hashes that survived
                # the edge filter, so the kept rows are those the reference
                # keeps
                keep, nodes, total = kept_node_layout(self.nodes, used_hashes)
                kmers = handle.compact_kmers(keep, total)
                handle.release()
                self._graph = None
            logger.info(f' - {len(kmers)} k-mers left')
            dt = time() - tik

        log_elapsed(dt)
        self.kmers = kmers
        self.nodes = nodes
        self.edges = edges
        self.graph = graph
        self.node_penalty = node_penalty
        self.subgraphs = subgraphs
        self._is_filtered = True

    @staticmethod
    def __filter_graph(nodes, handle, edge_weight_th):
        """Drop edges with weight <= floor(th) and isolated nodes; build the
        adjacency (HashGraph). Only the edges that survive the weight
        threshold leave the device (`DeviceGraph.filter_edges`)."""
        logger.info(' - Filtering graph edges and nodes...')
        n_nodes, n_edges = len(nodes), handle.n_edges

        edges = handle.filter_edges(edge_weight_th)
        logger.info(f' - Removed {n_edges - len(edges)} edges with weight<{edge_weight_th:.3f}, {len(edges)} edges left')

        nodes_to_keep = np.unique(np.concatenate([edges['first'], edges['second']])) if len(edges) else np.zeros(0, np.uint64)
        nodes = nodes[np.searchsorted(nodes['hash'], nodes_to_keep)]
        logger.info(f' - Removed {n_nodes - len(nodes)} isolated nodes, {len(nodes)} nodes left')

        logger.info(' - Building graph...')
        graph = HashGraph()
        graph.add_edges(zip(edges['first'].tolist(), edges['second'].tolist()))
        node_penalty = dict(zip(nodes['hash'].tolist(), nodes['penalty'].tolist()))
        return nodes, edges, graph, node_penalty


def _device_jaccard(assemblies: Assemblies, config: Config, records=None) -> NDArray:
    """Jaccard matrix of bottom-k MinHash sketches (the mash-free
    estimator), on the run's device; the host builds
    (``device_backend='numpy'|'oracle'``) promise no GPU, so there on the
    CPU. ``records`` are the build's parsed codes per assembly; without
    them (the multi-host build keeps none) the FASTAs are parsed here."""
    device = 'cpu' if config.device_backend in ('numpy', 'oracle') else config.device
    logger.info(' - Computing on-device MinHash sketches...')
    if records is None:
        records = [codes for _, codes in iter_assemblies([str(p) for p in assemblies.path],
                                                           config.n_cpu)]
    with timeline.span('threshold.sketches', assemblies=len(records)) as span:
        cut = {}  # the cut path's candidates and fallbacks; empty on the torch path
        sketches = device_sketches(records, config.kmerlen, config.sketchsize,
                                   seed_pattern=config.seed_pattern, device=device,
                                   n_cpu=config.n_cpu, stats=cut)
        if cut:  # a run whose assemblies left the kernels says so in its log
            logger.info(f" - Sketch cut: {cut['candidates']} candidates kept, "
                        f"{cut['fallbacks']} of {len(records)} assemblies redone in full")
        if span:
            bases = sum(stream_bases(recs, config.seed_pattern) for recs in records)
            span.set(bases=bases, h2d_bytes=bases, **cut)  # one uint8 code a position
    pairs = len(sketches) * (len(sketches) + 1) // 2
    with timeline.span('threshold.jaccard', pairs=pairs,
                       blocks=-(-pairs // pair_block(config.sketchsize))):
        return sketch_jaccard_matrix(sketches, config.sketchsize, device=device)


def _expected_frac(jaccard_mtx: NDArray) -> np.floating:
    """E(frac) = mean(2J / (1+J))."""
    return np.mean(2 * jaccard_mtx / (1 + jaccard_mtx))


def frac_to_penalty(frac_tar, frac_neg):
    """Penalty = L2 norm of (1 - frac_tar, frac_neg)."""
    return ((1 - frac_tar) ** 2 + frac_neg ** 2) ** 0.5


def minimizer_expectations(nodes: NDArray, n_tar: int, n_neg: int):
    """(expected k-mer absence in targets, expected presence in
    non-targets) from the minimizer counts: the estimate without mash."""
    frac_tar = nodes['n_tar'] / n_tar
    e_absence_tar = 1 - np.sum(frac_tar * nodes['n_tar']) / np.sum(nodes['n_tar'])
    frac_neg = nodes['n_neg'] / n_neg
    e_presence_neg = np.sum(frac_neg * nodes['n_tar']) / np.sum(nodes['n_tar'])
    return e_absence_tar, e_presence_neg


def penalty_threshold(e_absence_tar, e_presence_neg, config: Config):
    """The node penalty threshold from the two expectations, scaled by the
    stringency and capped at ``config.penalty_th_cap``."""
    logger.info(f' - expected k-mer absence in targets: {e_absence_tar:.5f}')
    logger.info(f' - expected k-mer presence in non-targets: {e_presence_neg:.5f}')
    penalty_th_mul = 1 - config.stringency / 10
    penalty_th = penalty_th_mul * (e_absence_tar * e_presence_neg) ** 0.5
    logger.info(f' - calculated penalty threshold: {penalty_th:.5f}')
    if penalty_th > config.penalty_th_cap:
        penalty_th = config.penalty_th_cap
        logger.warning(f' - calculated penalty threshold is too large (capped at {penalty_th})')
    return penalty_th


def edge_weight_threshold(penalty_th, n_tar: int, config: Config):
    """Edges of weight <= this (truncated) are dropped before the search."""
    return config.edge_w_th_mul * (1 - penalty_th) * n_tar


def get_kmers(
    assemblies: Assemblies, config: Config, state: RunState
) -> tuple[KmerGraph, NDArray | None]:
    """Build the KmerGraph, estimate thresholds, and filter."""
    # the device sketches need the parsed codes right after the build: the
    # build keeps them, so every FASTA is parsed once per run
    need_sketches = (
        config.penalty_th is None and not config.no_filter
        and config.sketch_mode == 'device'
    )
    kmers = KmerGraph(
        assemblies, config.kmerlen, config.windowsize, config.n_cpu,
        config.low_memory, backend=config.device_backend,
        keep_codes=need_sketches, devices=config.devices, device=config.device,
    )
    if config.no_filter:
        kmers.materialize()  # graph.npz dump needs the full arrays on host
        return kmers, None

    n_tar = state.n_tar
    n_neg = state.n_neg
    penalty_th = config.penalty_th

    if penalty_th is None:
        logger.info('Calculating penalty threshold...')
        with timeline.span('phase.threshold'):
            tik = time()
            if config.sketch_mode == 'device':
                handle = kmers._graph
                jaccard = _device_jaccard(assemblies, config, records=handle.record_codes)
                handle.record_codes = None  # free the kept parse
                e_absence_tar = 1 - _expected_frac(jaccard[:n_tar, :n_tar])
                e_presence_neg = _expected_frac(jaccard[n_tar:, :n_tar])
            elif config.sketch_mode != 'minimizer' and config.run_mash and HAS_MASH:
                jaccard = assemblies.mash(
                    kmerlen=config.kmerlen,
                    sketchsize=config.sketchsize,
                    out_path=state.working_dir / WORKINGDIR.mash,
                    overwrite=config.overwrite,
                    n_cpu=config.n_cpu,
                )
                e_absence_tar = 1 - _expected_frac(jaccard[:n_tar, :n_tar])
                e_presence_neg = _expected_frac(jaccard[n_tar:, :n_tar])
            else:
                if config.run_mash and config.sketch_mode != 'minimizer':
                    logger.error('Mash is not installed. Falling back to minimizer sketches.')
                e_absence_tar, e_presence_neg = minimizer_expectations(kmers.nodes, n_tar, n_neg)
                jaccard = None
            penalty_th = penalty_threshold(e_absence_tar, e_presence_neg, config)
            dt = time() - tik
        log_elapsed(dt)
    else:
        logger.warning('Penalty threshold is provided (--penalty-th), skip auto estimation')
        jaccard = None

    edge_weight_th = edge_weight_threshold(penalty_th, n_tar, config)

    gap_len = (config.windowsize + 1) // 2
    min_nodes = max(config.min_nodes_floor, config.min_len // gap_len + 1)
    if config.max_len is None:
        max_nodes = config.max_nodes_cap
    else:
        max_nodes = config.max_len // gap_len + 1

    kmers.filter(penalty_th, edge_weight_th, min_nodes, max_nodes, state.rng)

    state.penalty_th = penalty_th
    state.edge_weight_th = edge_weight_th
    state.min_nodes = min_nodes
    state.max_nodes = max_nodes
    return kmers, jaccard

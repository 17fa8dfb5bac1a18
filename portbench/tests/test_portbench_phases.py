"""The `Finished in` reader, keyed by the heading before each line."""
from portbench.phases import phase_seconds

HEAD = '2026-01-01 00:00:00 | {:<8} | {}'


def _log(*msgs):
    return '\n'.join(HEAD.format(level, msg) for level, msg in msgs)


BASE = [
    ('INFO', 'Running seqwin-tpu-torch v0.1'),
    ('INFO', 'Building minimizer graph from 171 assemblies...'),
    ('INFO', ' - Found 8000000 minimizers'),
    ('INFO', ' - Finished in 0:00:01.250000'),
    ('INFO', 'Calculating penalty threshold...'),
    ('ERROR', 'Mash is not installed. Falling back to minimizer sketches.'),
    ('INFO', ' - calculated penalty threshold: 0.05000'),
    ('INFO', ' - Finished in 0:00:00.050000'),
    ('INFO', 'Extracting low-penalty subgraphs from the k-mer graph...'),
    ('INFO', ' - Finished in 0:00:00.400000'),
    ('INFO', 'Finding a representative for each low-penalty subgraph...'),
    ('INFO', ' - Finished in 0:00:03.000000'),
]
BLAST = [
    ('INFO', 'Evaluating candidate signatures with BLAST...'),
    ('INFO', 'Creating a BLAST database of all assemblies...'),
    ('INFO', ' - Finished in 0:00:20.000000'),
    ('INFO', 'BLAST checking signatures against all assemblies (more sensitive but slower)...'),
    ('WARNING', 'Signature at index 3 (0-based) has no BLAST hit in any assembly (ACGT...)'),
    ('INFO', ' - Finished in 0:01:02.500000'),
]
WANT = {'build_graph': 1.25, 'threshold': 0.05, 'subgraphs': 0.4, 'markers': 3.0}


def test_without_blast():
    assert phase_seconds(_log(*BASE)) == WANT


def test_blast_lines_shift_nothing():
    # BLAST's database comes before the markers' heading in a real log; its
    # lines here sit between the phases and after them
    log = _log(*BASE[:4], *BLAST[1:3], *BASE[4:], *BLAST)
    assert phase_seconds(log) == WANT


def test_untimed_and_partial_logs():
    assert phase_seconds('') == {}
    assert phase_seconds(_log(*BASE[:3])) == {}
    assert phase_seconds(_log(('INFO', ' - Finished in 0:00:01'))) == {}
    assert phase_seconds(_log(*BASE[1:2], ('INFO', ' - Finished in 1 day, 0:00:01.5'))) == {
        'build_graph': 86401.5}

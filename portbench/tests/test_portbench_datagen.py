"""The golden171 proxy generator: the same seed gives the same bytes."""
import hashlib

import pytest

from portbench.datagen import golden171_proxy as gen

PARAMS = dict(n_tar=2, n_neg=3, genome_len=5000, tar_snp_rate=0.005, neg_snp_rate=0.01,
              neg_root_divergence=0.08, n_run=[10, 300])
# sha256 over (file name, bytes) of every file, seed 3141592653589 (above 2^32)
DIGESTS = {
    2: 'c9021fd94d017b8fe278867b2c76067616d3345838afaedc7454a5415eac685b',
    1: '2647d91331b50681005d9f018799cd2848f3a85bc0b70b0d601d1776eb4c5df7',
}


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize('threads', [1, 3])
@pytest.mark.parametrize('records', [2, 1])
def test_bytes_for_a_fixed_seed(tmp_path, records, threads):
    data = gen.generate(tmp_path, 3141592653589, records_per_genome=records, threads=threads,
                        **PARAMS)
    assert _digest(data['paths']) == DIGESTS[records]
    assert data['is_target'] == [True, True, False, False, False]
    assert len(data['record_lengths']) == 5 * records
    assert all(sum(data['record_lengths'][i * records:(i + 1) * records]) == 5000 for i in range(5))


def test_fasta_layout(tmp_path):
    data = gen.generate(tmp_path, 7, records_per_genome=2, **PARAMS)
    lines = data['paths'][0].read_text().splitlines()
    assert lines[0] == '>proxy_0_0'
    assert max(len(ln) for ln in lines) == 80
    assert set(''.join(ln for ln in lines if not ln.startswith('>'))) <= set('ACGTN')


def test_seeds_differ(tmp_path):
    a = gen.generate(tmp_path / 'a', 1, records_per_genome=1, **PARAMS)
    b = gen.generate(tmp_path / 'b', 2, records_per_genome=1, **PARAMS)
    assert _digest(a['paths']) != _digest(b['paths'])


def test_content_seed_orders_one_set_of_genomes(tmp_path):
    runs = [gen.generate(tmp_path / str(s), s, records_per_genome=1, content_seed=171, **PARAMS)
            for s in (1, 2)]
    assert all(r['is_target'] == [True, True, False, False, False] for r in runs)
    contents = [[p.read_bytes() for p in r['paths']] for r in runs]
    assert sorted(contents[0]) == sorted(contents[1])
    assert contents[0] != contents[1]
    # targets stay first
    assert all(c.startswith(b'>proxy_0_') or c.startswith(b'>proxy_1_') for c in contents[0][:2])

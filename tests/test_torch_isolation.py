"""seqwin_tpu_torch stands alone: no JAX, nothing of seqwin_tpu, no pandas
or pydantic, and no quiet CPU fallback when the default device (the GPU) is
missing."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / 'seqwin_tpu_torch'


def test_import_leaves_jax_and_seqwin_tpu_out(tmp_path):
    code = (
        'import sys\n'
        f'sys.path.insert(0, {str(REPO)!r})\n'
        'import seqwin_tpu_torch\n'
        'seqwin_tpu_torch.graph.build\n'
        'import seqwin_tpu_torch.engine.hybrid, seqwin_tpu_torch.engine.aggregate\n'
        'import seqwin_tpu_torch.engine.minimizer\n'
        'import seqwin_tpu_torch.engine.timeline\n'
        'import seqwin_tpu_torch.ops.host_build, seqwin_tpu_torch.ops.oracle\n'
        'import seqwin_tpu_torch.parallel.distributed, seqwin_tpu_torch.parallel.multihost\n'
        'import seqwin_tpu_torch.core, seqwin_tpu_torch.cli, seqwin_tpu_torch.__main__\n'
        'import seqwin_tpu_torch.pipeline.kmers, seqwin_tpu_torch.pipeline.subgraphs\n'
        'import seqwin_tpu_torch.pipeline.markers, seqwin_tpu_torch.mash\n'
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'seqwin_tpu', 'pandas', 'pydantic')]\n"
        'print(bad)\n'
    )
    res = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '[]'


def test_sources_name_no_jax():
    files = [p for p in PKG.rglob('*') if p.suffix in ('.py', '.cu', '.cpp')]
    assert any(p.suffix == '.cu' for p in files)
    for p in files:
        text = p.read_text()
        assert not re.search(r'\bjax\b', text), p
        assert not re.search(r'\bseqwin_tpu\.', text), p


def test_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from seqwin_tpu_torch.graph.build import build, build_deferred

    fa = tmp_path / 'a.fa'
    fa.write_text('>r\nACGTACGTACGTACGTACGTACGTACGT\n')
    with pytest.raises(RuntimeError, match='CUDA'):
        build([fa], 5, 3, [True])
    with pytest.raises(RuntimeError, match='CUDA'):
        build_deferred([fa], 5, 3, [True])


def test_cli_without_gpu_exits_nonzero(tmp_path):
    """`python -m seqwin_tpu_torch` with no card stops with the CUDA error
    before it writes anything; it does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    lists = []
    for role in ('tar', 'neg'):
        fa = tmp_path / f'{role}.fa'
        fa.write_text('>r\n' + 'ACGTTGCAAGT' * 40 + '\n')
        txt = tmp_path / f'{role}.txt'
        txt.write_text(f'{fa}\n')
        lists.append(txt)
    res = subprocess.run(
        [sys.executable, '-m', 'seqwin_tpu_torch', '--tar-paths', str(lists[0]),
         '--neg-paths', str(lists[1]), '--prefix', str(tmp_path), '--title', 'out',
         '--no-mash', '--no-blast'],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert res.returncode != 0
    assert 'CUDA' in res.stderr
    assert not (tmp_path / 'out').exists()

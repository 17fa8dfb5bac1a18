"""What a run loads: no JAX, no JAX package (by whole top-level name; the
port's name begins with the JAX package's), and, for the reference, nothing
of the port."""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'seqwin_tpu'}

_RUN = '''
import dataclasses, io, json, sys, contextlib
sys.path[:0] = [{repo!r}, {tests!r}]
from conftest import CpuStandIn
from seqwin_tpu_torch import cli
orig = cli.config_from_args
cli.config_from_args = lambda a: dataclasses.replace(orig(a), device='cpu')
from portbench import control, harness, spec
bench = json.loads({bench!r})
for kind, names in (('metrics', [m['name'] for m in bench['per_layer']]),
                    ('end_to_end', [m['name'] for m in bench['end_to_end']])):
    for name in names:
        spec.module(kind, name)
with contextlib.redirect_stdout(io.StringIO()):
    rc = harness.main(['--workload', 'tiny.cli', '--seed', '5', '--seconds', '0.1', '--trace', '1'],
                      bench=bench, dev=CpuStandIn())
print(json.dumps([rc, sorted({{m.split('.')[0] for m in sys.modules}})]))
'''

_REFERENCE = '''
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r})
from portbench.datagen import golden171_proxy as gen
from portbench.reference import pipeline
with tempfile.TemporaryDirectory() as td:
    d = gen.generate(Path(td), 5, 3, 4, 20000, 2, 0.005, 0.01, 0.08, [10, 300])
    out = pipeline.run(d['paths'], d['is_target'], 21, 200, ['--no-mash', '--no-blast'], 'cpu', n_cpu=2)
print(json.dumps([len(out.markers), sorted({{m.split('.')[0] for m in sys.modules}})]))
'''


def _top_level(code: str):
    res = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tiny_bench):
    rc, names = _top_level(_RUN.format(repo=str(REPO), tests=str(Path(__file__).parent),
                                       bench=json.dumps(tiny_bench)))
    assert rc == 0
    assert 'seqwin_tpu_torch' in names and 'torch' in names
    assert not FORBIDDEN & set(names)


def test_the_reference_loads_nothing_of_the_port():
    n_markers, names = _top_level(_REFERENCE.format(repo=str(REPO)))
    assert n_markers > 0
    assert not (FORBIDDEN | {'seqwin_tpu_torch'}) & set(names)

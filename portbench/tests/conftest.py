"""Fixtures of the harness's tests: a one-cell benchmark over the tiny
configuration, and a stand-in for the card that runs the port on the CPU."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


class CpuStandIn:
    """The harness's card interface over the CPU: no card is looked for."""

    platform = 'cpu'
    torch_device = 'cpu'

    def missing(self, chips):
        return None

    def kind(self):
        return 'cpu'

    def power_limit(self):
        return 'n/a'

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 1

    def free(self):
        pass

    def activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU]


def tiny_bench_dict() -> dict:
    return {
        'configs': [{'name': 'tiny', 'file': 'portbench/tests/data/tiny.json'}],
        'workloads': [{'name': 'tiny.cli', 'config': 'tiny', 'traffic': 'cli', 'chips': 1}],
        'end_to_end': [{'name': 'job_s', 'unit': 's'}, {'name': 'peak_device_gib', 'unit': 'GiB'},
                       {'name': 'setup_s', 'unit': 's'}],
        'per_layer': [{'name': n, 'unit': 's'} for n in
                      ('outside_phases_s', 'build_graph_s', 'threshold_s', 'subgraphs_s',
                       'markers_s', 'b1_launches', 'device_idle_pct')],
    }


@pytest.fixture
def tiny_bench():
    return tiny_bench_dict()


@pytest.fixture
def cuda():
    """The card, for the tests marked ``gpu``; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.fixture
def on_cpu(monkeypatch):
    """Jobs run the port on the CPU (its plain kernels)."""
    from seqwin_tpu_torch import cli

    orig = cli.config_from_args
    monkeypatch.setattr(cli, 'config_from_args',
                        lambda args: dataclasses.replace(orig(args), device='cpu'))
    return CpuStandIn()

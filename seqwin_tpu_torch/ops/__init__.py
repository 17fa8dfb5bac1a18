"""Counterpart: `seqwin_tpu/ops/`."""

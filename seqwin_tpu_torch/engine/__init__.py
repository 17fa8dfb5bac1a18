"""Counterpart: `seqwin_tpu/engine/`."""

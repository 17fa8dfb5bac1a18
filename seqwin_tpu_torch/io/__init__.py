"""Counterpart: `seqwin_tpu/io/`."""

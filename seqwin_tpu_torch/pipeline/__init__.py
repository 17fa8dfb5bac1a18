"""The pipeline after the graph build: threshold and filter (`kmers`),
subgraph search (`subgraphs`), signatures (`markers`).

Counterpart: `seqwin_tpu/pipeline/`.
"""

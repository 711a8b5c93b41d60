"""The bench replay corpus (counterpart of ``anomod/io/dataset.py``).

Only the synthetic bench corpus is ported so far; the ingest cache and the
reference-artifact loaders are later work.
"""

from __future__ import annotations

from anomod_torch import labels as labels_mod
from anomod_torch import synth
from anomod_torch.schemas import SpanBatch, concat_span_batches


def load_bench_corpus(testbed: str, n_traces: int) -> SpanBatch:
    """The concatenated replay corpus: ``synth.generate_spans`` over every
    label of ``testbed`` (13 experiments), ``n_traces`` traces each."""
    return concat_span_batches(
        [synth.generate_spans(l, n_traces=n_traces)
         for l in labels_mod.labels_for_testbed(testbed)])

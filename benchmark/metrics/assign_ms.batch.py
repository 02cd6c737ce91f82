"""assign_ms.batch: device milliseconds per batch of the operations
launched inside the vocabulary tree's `vocab.assign` span (the tree
descent of the batch's query descriptors), over the traced slice's
batches (benchmark/vocab_spans.py)."""

from benchmark import vocab_spans


def read(ctx):
    got = vocab_spans.read(ctx)
    return None if got is None else got.device_ms_per_batch(("vocab.assign",))

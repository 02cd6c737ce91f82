"""verify_ms.batch: device milliseconds per batch of the operations
launched inside the vocabulary tree's spatial verification, the spans
`vocab.verify` (candidates, the frames' stage-in, the scores added),
`vocab.match` (the candidate table, `vocab_match_kernel`, the 1-to-1
rule) and `vocab.vote` (the segmented vote-and-verify), over the traced
slice's batches (benchmark/vocab_spans.py). None for a program without
these spans."""

from benchmark import vocab_spans


def read(ctx):
    got = vocab_spans.read(ctx)
    return None if got is None else got.device_ms_per_batch(
        ("vocab.verify", "vocab.match", "vocab.vote"))

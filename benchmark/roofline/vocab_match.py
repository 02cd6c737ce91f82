"""`vocab_match_kernel` (csrc/vocab_match.cu): what one batch's query
images need, counted from the reference alone. Bytes: each distinct
posting entry that the batch's query words touch, its 32-bit image read
once (4 bytes); its 64-bit signature and 32-bit database feature read
once (12 bytes more) only where that image is a candidate of a query
image with a feature of the entry's word, as the kernel reads them only
then; 12 bytes for each query feature (word and signature), the
[Q, n_images] int32 candidate table read once, and each record emitted
(a match of a query feature and an entry of one of its query's
candidates within the Hamming limit) written once at 16 bytes. No
operations are counted: the bound is the bytes over the memory rate."""


def work(distinct_entries: int, candidate_entries: int, features: int,
         q: int, n_images: int, records: int) -> tuple[float, float]:
    return 0.0, float(4 * distinct_entries + 12 * candidate_entries
                      + 12 * features + 4 * q * n_images + 16 * records)

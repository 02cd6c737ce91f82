"""`vocab_score_kernel` (csrc/vocab_score.cu): what one batch's query
images need, counted from the reference alone. Bytes: each distinct
posting entry that the batch's query words touch, read once at 12 bytes
(a 64-bit signature and a 32-bit image id; burstiness follows from the
lists), 12 bytes for each query feature (word and signature), and the
[Q, n_images] float32 scores written once. No operations are counted:
the bound is the bytes over the memory rate."""


def work(distinct_entries: int, features: int, q: int,
         n_images: int) -> tuple[float, float]:
    return 0.0, float(12 * distinct_entries + 12 * features
                      + 4 * q * n_images)

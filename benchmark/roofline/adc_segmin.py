"""`adc_segmin_kernel` (csrc/adc_scan.cu): one batch of b queries scored
against n rows of m-byte PQ codes at width d, counted from the cell's own
n and b (not the padded arguments): 2*n*d*b int8 operations; bytes read
or written once: n*m of codes, n*4 of norms, b*d*4 of queries and b*k*8
of output."""


def work(n: int, b: int, d: int, m: int, k: int) -> tuple[float, float]:
    return 2.0 * n * d * b, float(n * m + n * 4 + b * d * 4 + b * k * 8)

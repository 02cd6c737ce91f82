"""`ivf_page_kernel` (csrc/ivf_scan.cu): what one batch's inputs need.
Operations: 2*d for each query and each row of that query's own probed
cells (`probed_rows`, summed over the batch). Bytes: the rows of the
union of the batch's probed cells (`union_rows`), each read once as m
bytes of code and 8 of norm and cell, plus b*d*4 of queries and b*k*8 of
output. The kernel's union scan does more than this: the share that
follows is the headroom, not a fault of the count."""


def work(probed_rows: int, union_rows: int, b: int, d: int, m: int,
         k: int) -> tuple[float, float]:
    return (2.0 * d * probed_rows,
            float(union_rows * (m + 8) + b * d * 4 + b * k * 8))

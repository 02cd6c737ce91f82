"""Command-line interface of the port (counterpart of `cvt_tpu.cli`).

Usage:  python -m cvt_tpu_torch.cli <command> [args]
Commands:
  serve   sharded query server over a saved flat ADC index

The other commands of `cvt_tpu.cli` are not ported yet. `serve` runs one
rank per process on the card (`--device cpu` asks for the CPU; without a
card and without it the command fails): alone it is a 1-rank group; under
torchrun every rank holds one shard of the codes:

    python -m cvt_tpu_torch.cli serve --index pack.npz --queries q.fvecs
    python -m cvt_tpu_torch.cli serve --index pack.npz --stdin < q.jsonl
    torchrun --nproc-per-node 4 -m cvt_tpu_torch.cli serve --index ...

Rank 0 prints one JSON line per query: {"ids": [...], "dists": [...]}.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _print_rows(d, i) -> None:
    for row_d, row_i in zip(np.asarray(d), np.asarray(i)):
        print(json.dumps({"ids": row_i.tolist(),
                          "dists": [round(float(x), 3) for x in row_d]}),
              flush=True)


def _stdin_lines(rank: int, world: int):
    """Non-empty stdin lines, read by rank 0 and broadcast to every rank,
    so that all ranks serve the same queries in the same order."""
    import torch.distributed as dist
    while True:
        line = [None]
        if rank == 0:
            for raw in sys.stdin:
                if raw.strip():
                    line[0] = raw.strip()
                    break
        if world > 1:
            dist.broadcast_object_list(line, src=0)
        if line[0] is None:
            return
        yield line[0]


def _cmd_serve(args):
    """Load a FlatADCIndex pack and serve queries with the sharded
    MultiHostADCServer + continuous QueryBatcher (BASELINE config 5's
    front end). Queries arrive as an fvecs file (batch mode) or
    line-delimited JSON float arrays on stdin (--stdin streaming mode)."""
    import torch.distributed as dist
    from cvt_tpu_torch.index import FlatADCIndex
    from cvt_tpu_torch.io.vecs import read_fvecs
    from cvt_tpu_torch.parallel.serving import (MultiHostADCServer,
                                                QueryBatcher,
                                                init_distributed,
                                                serving_mesh)
    from cvt_tpu_torch.quant.opq import OPQ

    rank = init_distributed(device=args.device)
    world = dist.get_world_size()
    idx = FlatADCIndex.load(args.index, device=args.device)
    quant = (OPQ(idx.rotation, idx.pq) if idx.rotation is not None
             else idx.pq)
    srv = MultiHostADCServer(quant, serving_mesh(), merge=args.merge)
    idx._materialize()
    srv.load(codes=idx._codes)
    if args.stdin:
        batcher = QueryBatcher(srv.serve, batch_size=args.batch, k=args.k,
                               max_wait_ms=args.max_wait_ms)
        try:
            for line in _stdin_lines(rank, world):
                q = np.asarray(json.loads(line), np.float32).reshape(1, -1)
                d, i = batcher.submit(q).result()
                if rank == 0:
                    _print_rows(d, i)
        finally:
            batcher.close()
        return
    queries = read_fvecs(args.queries)
    for s in range(0, len(queries), args.batch):
        d, i = srv.serve(queries[s:s + args.batch], args.k)
        if rank == 0:
            _print_rows(d.cpu(), i.cpu())


def main(argv=None):
    p = argparse.ArgumentParser(prog="cvt_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("serve")
    g.add_argument("--index", required=True)
    g.add_argument("--queries", default=None)
    g.add_argument("--stdin", action="store_true")
    g.add_argument("--k", type=int, default=10)
    g.add_argument("--batch", type=int, default=1024)
    g.add_argument("--merge", default="allgather",
                   choices=["allgather", "ring"])
    g.add_argument("--max-wait-ms", type=float, default=5.0)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    g.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    import torch.distributed as dist
    try:
        return args.fn(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

"""Sharded ADC serving (BASELINE config 5) over torch.distributed.

Counterpart of `cvt_tpu.parallel.serving`:
  * init_distributed() — starts the process group (idempotent): under
    torchrun from its environment, otherwise a 1-rank group through a
    FileStore in a temporary directory (no TCP port). NCCL on the card
    by default, gloo only for device="cpu"; a failed start raises,
    nothing switches backend.
  * MultiHostADCServer — each rank holds its own shard of the codes
    ([per, M] uint8 on its device), runs the `adc_segmin` kernel on it
    and merges candidates over the 'db' group with one all_gather or a
    ring of point-to-point exchanges (`merge='ring'`), whose first step
    is in flight while serve_pipelined() launches the next micro-batch's
    scan.
  * QueryBatcher — continuous batching front end: callers submit query
    blocks; a background flusher pads them to the serving batch and
    resolves per-caller futures.

Every rank of a mesh calls serve() with the same batch, in the same
order (the collectives must stay in lockstep), and gets the same result.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import queue
import shutil
import tempfile
import threading
from concurrent.futures import Future

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cvt_tpu_torch.ops.kernels.adc_scan import _quantize_codebooks
from cvt_tpu_torch.ops.topk import merge_topk
from cvt_tpu_torch.parallel.mesh import axis_size, make_mesh, mesh_device
from cvt_tpu_torch.parallel.sharded_search import (_gather_merge,
                                                   _local_pallas_topk,
                                                   _place_quantizer, _rotate,
                                                   _segment_plan)
from cvt_tpu_torch.utils.device import resolve_device


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> int:
    """Start the default process group once; later calls return the rank.

    Under torchrun (RANK / WORLD_SIZE / MASTER_ADDR in the environment)
    every process joins through the environment; with num_processes > 1
    and coordinator_address ('host:port') through TCP; otherwise as the
    one rank of a group whose store is a file in a temporary directory.
    On the card (the default, `resolve_device`) each process takes card
    LOCAL_RANK (or rank mod the card count) and an NCCL group, started
    eagerly so that a failure raises here; device="cpu" asks for a gloo
    group. Without a card and without that request it raises. Returns the
    process's rank."""
    if dist.is_initialized():
        return dist.get_rank()
    kind = resolve_device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process group for device {kind!r}")
    cuda = kind == "cuda"
    backend = "nccl" if cuda else "gloo"
    env = os.environ
    kw = {}
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        rank = int(env["RANK"])
        local = int(env.get("LOCAL_RANK", rank))
        kw["init_method"] = "env://"
    elif num_processes is not None and num_processes > 1:
        rank = int(process_id)
        local = rank
        kw.update(init_method=f"tcp://{coordinator_address}", rank=rank,
                  world_size=num_processes)
    else:
        rank = local = 0
        root = tempfile.mkdtemp(prefix="cvt_store_")
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        kw.update(store=dist.FileStore(os.path.join(root, "store"), 1),
                  rank=0, world_size=1)
        if cuda:
            # one rank needs no network: bootstrap NCCL on the loopback
            env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if cuda:
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    return dist.get_rank()


def serving_mesh(device_type: str | None = None, axis: str = "db"):
    """1-D mesh over every rank of the group, in rank order."""
    return make_mesh({axis: dist.get_world_size()}, device_type)


class _RingMerge:
    """ring_merge_topk as posted work. The constructor posts step 1 (send
    the local candidates to rank r+1, receive from rank r-1, both
    asynchronous); finish() waits on it, merges, and runs the remaining
    S-2 steps. The buffer passed on is the one received, so step s brings
    rank r-s's candidates, merged in the order `cvt_tpu`'s ppermute ring
    merges them ([acc, buf], ties toward acc)."""

    def __init__(self, d, i, group, k: int):
        self.group, self.k = group, k
        self.s = dist.get_world_size(group)
        r = dist.get_rank(group)
        self.nxt = dist.get_global_rank(group, (r + 1) % self.s)
        self.prv = dist.get_global_rank(group, (r - 1) % self.s)
        self.acc = (d, i)
        self.left = self.s - 1
        if self.left:
            self._post(d.contiguous(), i.contiguous())

    def _post(self, d, i) -> None:
        self.buf = (torch.empty_like(d), torch.empty_like(i))
        ops = [dist.P2POp(dist.isend, d, self.nxt, self.group, tag=0),
               dist.P2POp(dist.isend, i, self.nxt, self.group, tag=1),
               dist.P2POp(dist.irecv, self.buf[0], self.prv, self.group,
                          tag=0),
               dist.P2POp(dist.irecv, self.buf[1], self.prv, self.group,
                          tag=1)]
        self.works = dist.batch_isend_irecv(ops)

    def finish(self):
        while self.left:
            for w in self.works:
                w.wait()
            d_buf, i_buf = self.buf
            self.acc = merge_topk(torch.cat([self.acc[0], d_buf], -1),
                                  torch.cat([self.acc[1], i_buf], -1),
                                  self.k)
            self.left -= 1
            if self.left:
                self._post(d_buf, i_buf)
        return self.acc


def ring_merge_topk(d, i, group, k: int):
    """Ring all-reduce with merge_topk as the reduction over `group` (the
    ProcessGroup of the JAX function's mesh axis): S-1 steps of
    batch_isend_irecv to rank r+1 and from rank r-1 rotate every shard's
    local candidates once around the ring; each stop merges into the
    local accumulator. The same result as all_gather + top-k, moving
    [B, k] per step."""
    return _RingMerge(d, i, group, k).finish()


def _on_device(dev: torch.device):
    """Make `dev` the current CUDA device (the batcher's flusher thread
    starts on card 0); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _gather_rows(x, group):
    """Concatenate every rank's rows of x over `group`, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


class MultiHostADCServer:
    """Sharded flat-ADC serving over the ranks of a mesh.

    The code matrix is split along N over the mesh's 'db' axis; each rank
    runs the `adc_segmin` kernel on its shard (the plain twin on a CPU
    mesh); candidates merge via all_gather (default) or a ring."""

    def __init__(self, quantizer, mesh: DeviceMesh | None = None, *,
                 axis: str = "db", dp_axis: str | None = None,
                 merge: str = "allgather", tile_n: int = 1024,
                 seg: int = 128):
        """axis: the database-sharding mesh axis. dp_axis: an optional
        query-parallel axis of a 2-D ('dp', 'db') mesh: each batch is
        split over it, and every rank gets the whole batch's results."""
        if merge not in ("allgather", "ring"):
            raise ValueError(merge)
        self.mesh = mesh if mesh is not None else serving_mesh()
        if dp_axis is not None and dp_axis not in self.mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {dp_axis!r}")
        self.device = mesh_device(self.mesh)
        self.pq, self.rotation = _place_quantizer(quantizer, self.device)
        self.axis = axis
        self.dp_axis = dp_axis
        self.group = self.mesh.get_group(axis)
        self.shard = self.mesh.get_local_rank(axis)
        if dp_axis is not None:
            self.dp_group = self.mesh.get_group(dp_axis)
            self.dp_rank = self.mesh.get_local_rank(dp_axis)
            self.dp_size = axis_size(self.mesh, dp_axis)
        self.merge = merge
        self.tile_n = tile_n
        self.seg = seg
        self._codes_l: torch.Tensor | None = None   # [per, M] uint8
        self._n = 0
        self._cb_q, self._srow = _quantize_codebooks(self.pq.codebooks)

    # ------------------------------------------------------------ ingest
    @property
    def n_shards(self) -> int:
        return axis_size(self.mesh, self.axis)

    def shard_rows(self, n_global: int) -> tuple[int, int, int]:
        """(start, stop, per_shard) of THIS RANK's row range for a database
        of n_global rows: each rank loads rows [start, stop) itself (stop
        may fall below start for a shard wholly past n_global)."""
        per = self._per_shard(n_global)
        start = self.shard * per
        return start, min(start + per, n_global), per

    def _per_shard(self, n: int) -> int:
        per = -(-n // self.n_shards)
        # each shard must be tile-aligned for the kernel
        t = max(self.tile_n, self.seg)
        return -(-per // t) * t

    def _rotate(self, x) -> torch.Tensor:
        return _rotate(x, self.rotation, self.device)

    def encode(self, x) -> np.ndarray:
        """Raw floats -> [N, M] uint8 codes (rotated space), on the host."""
        return self.pq.encode(self._rotate(x)).cpu().numpy()

    def load_local(self, local_codes, *, n_global: int | None = None):
        """Per-rank shard ingestion: THIS rank supplies only its rows
        (uint8 [n_local, M], already encoded, covering shard_rows()); no
        rank ever holds the whole database."""
        local = torch.as_tensor(local_codes, device=self.device)
        local = local.to(torch.uint8)
        if n_global is None:
            n_global = local.shape[0] * self.n_shards
        per = self._per_shard(n_global)
        if local.shape[0] > per:
            raise ValueError(f"{local.shape[0]} local rows exceed the "
                             f"shard's {per}")
        local = torch.nn.functional.pad(local, (0, 0, 0, per - local.shape[0]))
        self._codes_l = local.contiguous()
        self._n = n_global
        self._per = per

    def load(self, x=None, *, codes=None) -> None:
        """Load from raw floats or codes of the WHOLE database, given
        alike on every rank; each rank keeps its own shard."""
        if codes is None:
            codes = self.encode(x)
        n = codes.shape[0]
        start, stop, _ = self.shard_rows(n)
        self.load_local(codes[start:max(start, stop)], n_global=n)

    # ------------------------------------------------------------- serve
    def _scan(self, q, k: int):
        """Rotate this rank's queries, scan its shard -> (dists, global
        ids) of its local top-k."""
        per, n = self._per, self._n
        tile_n, seg = _segment_plan(per, self.tile_n, self.seg, k)
        start = self.shard * per
        d, i = _local_pallas_topk(self._rotate(q), self._codes_l, self._cb_q,
                                  self._srow, k, min(max(n - start, 0), per),
                                  tile_n, seg)
        return d, i + start

    def _dp_slice(self, q):
        """This rank's rows of a batch split over 'dp' (whole without)."""
        if not self.dp_axis:
            return q
        bl = q.shape[-2] // self.dp_size
        return q[..., self.dp_rank * bl:(self.dp_rank + 1) * bl, :]

    def serve(self, q, k: int):
        """One serving step: q [B, D] raw space -> (dists, global ids),
        the whole batch's on every rank. With a dp axis the batch is
        zero-padded to a multiple of its size, and the pad rows dropped."""
        if self._codes_l is None:
            raise RuntimeError("load() first")
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        b = q.shape[0]
        if self.dp_axis:
            bpad = -(-b // self.dp_size) * self.dp_size
            q = torch.nn.functional.pad(q, (0, 0, 0, bpad - b))
        with _on_device(self.device):
            d, i = self._scan(self._dp_slice(q), k)
            if self.merge == "ring":
                d, i = ring_merge_topk(d, i, self.group, k)
            else:
                d, i = _gather_merge(d, i, self.group, k)
            if self.dp_axis:
                d = _gather_rows(d, self.dp_group)
                i = _gather_rows(i, self.dp_group)
        d, i = d[:b], i[:b]
        return d, torch.where(i < self._n, i, -1)

    def serve_pipelined(self, q_microbatches, k: int):
        """Double-buffered serving over T micro-batches: micro-batch t's
        ring exchange is posted before micro-batch t+1's scan is
        launched and waited on after it, so the exchange is in flight
        while the kernel runs. Requires merge='ring'.

        q_microbatches: [T, B_mb, D]. Returns (dists [T*B_mb, k], ids)."""
        if self.merge != "ring":
            raise ValueError("serve_pipelined requires merge='ring'")
        if self._codes_l is None:
            raise RuntimeError("load() first")
        qs = torch.as_tensor(q_microbatches, dtype=torch.float32,
                             device=self.device)
        t, b_mb, _ = qs.shape
        if self.dp_axis and b_mb % self.dp_size:
            raise ValueError(
                f"micro-batch size {b_mb} must be a multiple of the "
                f"'{self.dp_axis}' mesh axis ({self.dp_size})")
        local = self._dp_slice(qs)
        outs = []
        with _on_device(self.device):
            prev = self._scan(local[0], k)
            for step in range(1, t):
                ring = _RingMerge(*prev, self.group, k)   # posted, in flight
                prev = self._scan(local[step], k)         # overlaps it
                outs.append(ring.finish())
            outs.append(ring_merge_topk(*prev, self.group, k))
            dd = torch.stack([o[0] for o in outs])       # [T, B_l, k]
            ii = torch.stack([o[1] for o in outs])
            if self.dp_axis:
                dd = _gather_rows(dd.transpose(0, 1), self.dp_group)
                ii = _gather_rows(ii.transpose(0, 1), self.dp_group)
                dd, ii = dd.transpose(0, 1), ii.transpose(0, 1)
        dd = dd.reshape(t * b_mb, k)
        ii = ii.reshape(t * b_mb, k)
        return dd, torch.where(ii < self._n, ii, -1)


class QueryBatcher:
    """Continuous query batching: callers submit [n_i, D] blocks; a
    background flusher concatenates them into fixed serving batches
    (padding the tail), runs `serve_fn`, and resolves per-caller futures.

    The flusher thread is serve_fn's only caller, so a server's collectives
    keep one order. Results come back as numpy arrays on the host."""

    def __init__(self, serve_fn, batch_size: int = 1024, k: int = 10,
                 max_wait_ms: float = 5.0):
        self.serve_fn = serve_fn
        self.batch_size = batch_size
        self.k = k
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, q) -> Future:
        """q [n, D] -> Future of (dists [n, k], ids [n, k])."""
        q = np.asarray(q, np.float32)
        fut: Future = Future()
        self._q.put((q, fut))
        return fut

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        import time as _time
        pending: list = []
        n_pend = 0
        deadline = None
        while not self._stop.is_set() or pending or not self._q.empty():
            timeout = self.max_wait
            if deadline is not None:
                timeout = max(deadline - _time.monotonic(), 0.0)
            try:
                item = self._q.get(timeout=timeout if pending else 0.05)
                pending.append(item)
                n_pend += item[0].shape[0]
                if deadline is None:
                    deadline = _time.monotonic() + self.max_wait
            except queue.Empty:
                pass
            flush = pending and (
                n_pend >= self.batch_size
                or (deadline is not None
                    and _time.monotonic() >= deadline)
                or self._stop.is_set())
            if flush:
                self._flush(pending)
                pending, n_pend, deadline = [], 0, None

    def _flush(self, pending) -> None:
        qs = np.concatenate([p[0] for p in pending], axis=0)
        n = qs.shape[0]
        bs = self.batch_size
        try:
            outs_d, outs_i = [], []
            for s in range(0, n, bs):
                blk = qs[s:s + bs]
                if blk.shape[0] < bs:
                    blk = np.concatenate(
                        [blk, np.zeros((bs - blk.shape[0], blk.shape[1]),
                                       np.float32)], axis=0)
                d, i = self.serve_fn(blk, self.k)
                # results may lie on the card: bring them to the host
                outs_d.append(np.asarray(torch.as_tensor(d).cpu()))
                outs_i.append(np.asarray(torch.as_tensor(i).cpu()))
            d = np.concatenate(outs_d, axis=0)[:n]
            i = np.concatenate(outs_i, axis=0)[:n]
            off = 0
            for q, fut in pending:
                m = q.shape[0]
                fut.set_result((d[off:off + m], i[off:off + m]))
                off += m
        except Exception as e:               # propagate to every caller
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)

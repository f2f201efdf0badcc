"""ELSAR-Serve: the long-lived continuous-batching query server (port of
``src/repro/serve/server.py``; DESIGN.md §14).

Request flow::

    client line ──> admission (FifoBatchScheduler.submit; sheds with
      │             Overloaded beyond the queue bound)
      │                    │
      │             batch loop: await next_batch()  — max-batch/max-wait
      │                    │                          coalescing window
      │             one worker thread: vectorized predict per shard
      │             replica (the RMI kernel on a CUDA index) + banded
      │             search + cache-fronted fetch
      │                    │
    response line <─ futures resolved on the event loop

The execution thread is deliberately singular: batches run in FIFO
order (admission order is preserved inside and across batches) and the
engine's NumPy work never contends with itself, while the event loop
keeps admitting and shedding — exactly the continuous-batching overlap
that makes the batched path beat per-request dispatch.

Transport is a newline-delimited JSON protocol over TCP or a unix
socket (``launch/serve.py``); keys and records travel hex-encoded.  The
in-process entry points (:meth:`QueryServer.point` /
:meth:`QueryServer.range_scan`) expose the same admission + batching
path without a socket — the open-loop benchmark drives those.

Every answer is byte-identical to a direct ``QueryEngine`` over the
same manifests: batching, caching, and routing change *when and where*
records are read, never *what* is returned.
"""

from __future__ import annotations

import asyncio
import binascii
import json
import time

import numpy as np

from repro_torch.core.config import ServeConfig
from repro_torch.core.stages.stats import ServeStats
from repro_torch.serve.cache import PartitionBlockCache
from repro_torch.serve.index import SortedFileIndex
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.scheduler import FifoBatchScheduler, Overloaded, Request


class QueryServer:
    """Continuous-batching point/range serving over one or many shards.

    ``target`` is a :class:`SortedFileIndex` (single sorted file), a
    :class:`ShardRouter` (sharded + replicated manifests), or a list of
    index/replica-group objects to wrap in a router.
    """

    def __init__(
        self,
        target,
        config: "ServeConfig | None" = None,
        *,
        own_indexes: bool = True,
    ):
        self.config = config or ServeConfig()
        if isinstance(target, ShardRouter):
            self.router = target
        elif isinstance(target, SortedFileIndex):
            self.router = ShardRouter([[target]])
        else:
            self.router = ShardRouter(
                [g if isinstance(g, (list, tuple)) else [g] for g in target]
            )
        widths = {
            g[0].key_width for g in self.router.groups
        }
        if len(widths) != 1:
            raise ValueError(
                f"shards disagree on key width: {sorted(widths)}"
            )
        self.key_width = widths.pop()
        self._own_indexes = own_indexes
        self.stats = ServeStats()
        self.scheduler = FifoBatchScheduler(
            max_batch=self.config.max_batch,
            max_wait_s=self.config.max_wait_ms / 1e3,
            max_queue=self.config.queue_bound,
            stats=self.stats,
        )
        self.cache = (
            PartitionBlockCache(self.config.cache_bytes, stats=self.stats)
            if self.config.cache_bytes > 0
            else None
        )
        self._loop_task: asyncio.Task | None = None
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set = set()
        self._t0 = 0.0
        self._stopped = asyncio.Event()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> "QueryServer":
        """Start the batch loop and (if configured) the listener."""
        self._t0 = time.perf_counter()
        self._loop_task = asyncio.create_task(
            self._batch_loop(), name="elsar-serve-batch-loop"
        )
        if self.config.socket_path:
            self._server = await asyncio.start_unix_server(
                self._handle_conn, path=self.config.socket_path
            )
        elif self.config.port or self.config.host:
            self._server = await asyncio.start_server(
                self._handle_conn, host=self.config.host,
                port=self.config.port,
            )
        return self

    @property
    def address(self):
        """Bound transport address: the socket path, or (host, port)."""
        if self.config.socket_path:
            return self.config.socket_path
        if self._server is None:
            return None
        return self._server.sockets[0].getsockname()[:2]

    async def stop(self, *, drain: bool = True) -> None:
        """Graceful drain: stop admitting, answer everything already
        queued, flush every connection, then shut down.  With
        ``drain=False`` queued requests fail immediately."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if not drain:
            self.scheduler.abort_pending(
                RuntimeError("server shutting down")
            )
        self.scheduler.close()
        if self._loop_task is not None:
            try:
                await asyncio.wait_for(
                    self._loop_task, timeout=self.config.drain_timeout_s
                )
            except asyncio.TimeoutError:
                self.scheduler.abort_pending(
                    RuntimeError("drain timeout exceeded")
                )
                self._loop_task.cancel()
        if self._conn_tasks:
            await asyncio.gather(
                *list(self._conn_tasks), return_exceptions=True
            )
        self.stats.wall_seconds = time.perf_counter() - self._t0
        if self._own_indexes:
            for g in self.router.groups:
                for idx in g:
                    idx.close()
        self._stopped.set()

    # ------------------------------------------------------------------
    # in-process query surface (the benchmark's entry point)
    # ------------------------------------------------------------------

    async def point(self, key: bytes) -> dict:
        """Admit one point lookup; resolves when its batch executes."""
        return await self.scheduler.submit("point", key)

    async def range_scan(self, lo_key: bytes, hi_key: bytes) -> dict:
        """Admit one inclusive range scan."""
        return await self.scheduler.submit("range", (lo_key, hi_key))

    # ------------------------------------------------------------------
    # batch loop + execution (the only consumer of the scheduler)
    # ------------------------------------------------------------------

    async def _batch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch = await self.scheduler.next_batch()
            if batch is None:
                return
            try:
                results = await loop.run_in_executor(
                    None, self._execute, batch
                )
            except Exception as e:  # defensive: fail the batch, not the loop
                results = [
                    (req, {"ok": False, "error": "internal",
                           "detail": str(e)})
                    for req in batch
                ]
            now = time.monotonic()
            self.stats.latencies_s.extend(
                [now - req.t_submit for req, _ in results]
            )
            for req, resp in results:
                if not req.future.done():
                    req.future.set_result(resp)

    def _execute(self, batch: "list[Request]"):
        """One coalesced dispatch (worker thread): points grouped per
        shard for a single vectorized predict, ranges split per shard.
        Returns ``[(request, response_dict), ...]``."""
        out: dict[int, dict] = {}
        by_shard: dict[int, list] = {}
        for req in batch:
            if req.kind == "point":
                sid = self.router.shard_for_key(req.payload)
                by_shard.setdefault(sid, []).append(req)
            else:
                out[req.seq] = self._execute_range(req)
                self.stats.n_range += 1
        for sid, reqs in by_shard.items():
            index = self.router.pick(sid)
            keys = np.frombuffer(
                b"".join(index.pad_key(r.payload) for r in reqs),
                dtype=np.uint8,
            ).reshape(len(reqs), self.key_width)
            rows, found = index.lookup(
                keys, use_kernels=self.config.use_kernels
            )
            records = (
                self.cache.fetch_rows(index, rows, found)
                if self.cache is not None
                else index.fetch_rows(rows, found)
            )
            for i, req in enumerate(reqs):
                rec = records[i]
                if found[i]:
                    blob = (
                        rec if isinstance(rec, bytes)
                        else np.ascontiguousarray(rec).tobytes()
                    )
                else:
                    blob = None
                out[req.seq] = {
                    "ok": True,
                    "found": bool(found[i]),
                    "record": blob,
                }
            self.stats.n_point += len(reqs)
        return [(req, out[req.seq]) for req in batch]

    def _execute_range(self, req: Request) -> dict:
        lo, hi = req.payload
        pieces, count = [], 0
        for sid, s_lo, s_hi in self.router.split_range(lo, hi):
            index = self.router.pick(sid)
            start, stop = index.range_bounds(s_lo, s_hi)
            if stop <= start:
                continue
            span = (
                self.cache.materialize(index, start, stop)
                if self.cache is not None
                else index.materialize(start, stop)
            )
            pieces.append(np.ascontiguousarray(span).tobytes())
            count += stop - start
        return {"ok": True, "count": count, "data": b"".join(pieces)}

    # ------------------------------------------------------------------
    # line protocol (newline-delimited JSON, keys/records hex)
    # ------------------------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        wlock = asyncio.Lock()
        pending: set = set()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                t = asyncio.create_task(
                    self._serve_line(line, writer, wlock)
                )
                pending.add(t)
                t.add_done_callback(pending.discard)
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        finally:
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._conn_tasks.discard(task)

    async def _serve_line(self, line: bytes, writer, wlock) -> None:
        rid = None
        try:
            msg = json.loads(line)
            rid = msg.get("id")
            op = msg.get("op")
            if op == "ping":
                resp = {"ok": True, "pong": True}
            elif op == "stats":
                resp = {"ok": True, "stats": self._stats_snapshot()}
            elif op == "point":
                resp = await self.point(
                    binascii.unhexlify(msg["key"])
                )
            elif op == "range":
                resp = await self.range_scan(
                    binascii.unhexlify(msg["lo"]),
                    binascii.unhexlify(msg["hi"]),
                )
            else:
                resp = {"ok": False, "error": "bad_request",
                        "detail": f"unknown op {op!r}"}
        except Overloaded:
            resp = {"ok": False, "error": "overloaded"}
        except RuntimeError:
            resp = {"ok": False, "error": "draining"}
        except (KeyError, ValueError, binascii.Error) as e:
            resp = {"ok": False, "error": "bad_request", "detail": str(e)}
        resp["id"] = rid
        for field in ("record", "data"):
            if isinstance(resp.get(field), (bytes, bytearray)):
                resp[field] = binascii.hexlify(resp[field]).decode()
        payload = (json.dumps(resp) + "\n").encode()
        async with wlock:
            try:
                writer.write(payload)
                await writer.drain()
            except (ConnectionError, OSError):
                pass  # client went away; nothing to deliver

    def _stats_snapshot(self) -> dict:
        snap = self.stats.as_dict()
        if not snap["wall_seconds"]:
            wall = time.perf_counter() - self._t0
            snap["wall_seconds"] = wall
            snap["qps"] = self.stats.n_queries / max(wall, 1e-9)
        return snap


async def serve_forever(target, config: ServeConfig) -> QueryServer:
    """Start a server and run until cancelled (``launch/serve.py``)."""
    server = await QueryServer(target, config).start()
    await server._stopped.wait()
    return server

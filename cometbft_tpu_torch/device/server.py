"""Verify device server: the persistent process that OWNS the card and
serves batched ed25519 verification to every other process on the host
(SURVEY §7 step 2 "device server"; the reference's analog boundary is
Go → cgo → curve25519-voi in-process — the device is held by one
process, so the boundary becomes a local socket).

Design:
- the kernels are built and warmed ONCE at startup, before traffic;
- requests from all connections accumulate in a queue and are flushed
  as one device tile (cross-request coalescing — the accumulate-and-
  flush stance SURVEY §7 prescribes for every verify call site: many
  small commits become one large lane-parallel batch);
- per-lane verdicts are routed back per request, so one bad signature
  in client A's commit never forces client B into a retry.

Port of `cometbft_tpu/device/server.py`. What differs:
- `DeviceServer` takes `device=` (default cuda, resolved by
  `resolve_device`: it raises without a card); the flush runs
  `verify_batch` there. The JAX package's platform probe (a CPU-backed
  server clamped its bucket to 64 because XLA:CPU compiles for minutes)
  and its compile ledger are dropped: eager torch compiles nothing.
- `_warm` builds and warms the kernels with `prewarm_verify_kernels`
  for the bucket, then runs one clean and one s-tampered verify, as the
  JAX package does.
- A flush that raises (a kernel build, launch or canary error) is
  answered with a status of its own, FLUSH_FAILED
  (`protocol.encode_flush_failed`), not UNPROCESSABLE: the port's client
  raises `DeviceFlushFailed` instead of verifying the batch locally. It
  is counted in `stats["flush_failures"]`. UNPROCESSABLE stays the
  answer to a batch the bucket cannot take.
- `stop()` also closes the open client connections and joins the
  server's threads, so none is left blocked on a socket or the card.
- Mesh mode (`mesh=True`) raises NotImplementedError (ROADMAP.md
  Queue 1: mesh and multi-GPU).
"""

from __future__ import annotations

import queue
import socket
import threading
from dataclasses import dataclass
from typing import List, Optional

from . import resolve_device
from ..ops.ed25519 import prewarm_verify_kernels, verify_batch
from ..trace import shared_tracer
from ..trace.context import TraceContext
from .health import CANARY_LANES
from .protocol import (decode_request, decode_request_trace,
                       encode_flush_failed, encode_response, recv_frame,
                       send_frame)


@dataclass
class _Job:
    sock: socket.socket
    lock: threading.Lock  # per-connection write lock
    req_id: int
    pubs: List[bytes]
    msgs: List[bytes]
    sigs: List[bytes]
    ctx: Optional[TraceContext] = None  # request trace trailer


class DeviceServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 bucket: int = 1024, max_msg_len: int = 256,
                 flush_us: int = 200, mesh: bool = False, device=None):
        if mesh:
            raise NotImplementedError(
                "the mesh device server is not ported yet (ROADMAP.md "
                "Queue 1: mesh and multi-GPU)")
        self.device = resolve_device(device)
        self.bucket = bucket
        self.max_msg_len = max_msg_len
        self.flush_s = flush_us / 1e6
        self._jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.addr = self._listener.getsockname()
        self._stop = threading.Event()
        self._conns: set = set()    # open client sockets, closed by stop()
        self._conns_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self.stats = {"requests": 0, "signatures": 0, "flushes": 0,
                      "flush_failures": 0}

    # --- device side ----------------------------------------------------------

    def _warm(self) -> None:
        """Build and warm the kernels for the configured bucket before
        accepting traffic (a first build or first launch must not land
        on a live commit): the RLC fast path, and — by feeding one
        tampered signature — the per-lane attribution it degrades to."""
        from ..crypto import ref_ed25519 as ref
        prewarm_verify_kernels(self.bucket, device=self.device)
        seed = b"\x01" * 32
        pub = ref.pubkey_from_seed(seed)
        sig = ref.sign(seed, b"warm")
        # corrupt a LOW byte of s (offset 32..63): the signature stays
        # structurally valid so the RLC batch EQUATION fails and the
        # per-lane attribution really runs (a corrupted R fails at
        # decompression, which attributes it without that path)
        bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        verify_batch([pub], [b"warm"], [sig], batch_size=self.bucket,
                     device=self.device)
        verify_batch([pub], [b"warm"], [bad], batch_size=self.bucket,
                     device=self.device)

    def _flush(self, jobs: List[_Job]) -> None:
        pubs: List[bytes] = []
        msgs: List[bytes] = []
        sigs: List[bytes] = []
        for j in jobs:
            pubs.extend(j.pubs)
            msgs.extend(j.msgs)
            sigs.extend(j.sigs)
        # one flush serves many requests (coalescing seam): the flush
        # span is a root that LINKS each submitting client's trailer
        # ctx, mirroring the ingest-flush/ticket relationship
        span = shared_tracer().start("device.flush", jobs=len(jobs),
                                     lanes=len(pubs))
        for j in jobs:
            span.link(j.ctx)
        try:
            oks = verify_batch(pubs, msgs, sigs, batch_size=self.bucket,
                               device=self.device)
        finally:
            span.end()
        self.stats["flushes"] += 1
        self.stats["signatures"] += len(pubs)
        off = 0
        for j in jobs:
            part = [bool(v) for v in oks[off:off + len(j.pubs)]]
            off += len(j.pubs)
            resp = encode_response(j.req_id, all(part), part)
            try:
                with j.lock:
                    send_frame(j.sock, resp)
            except OSError:
                pass  # client gone; its lanes were still verified

    def _device_routine(self) -> None:
        """Single device writer: accumulate jobs, flush as one tile.
        A failing flush (a kernel build, launch or canary error) must
        never kill this thread — it is the server's ONLY writer, and
        a dead writer leaves every future client hanging silently.
        Each request of the failed batch is answered FLUSH_FAILED, which
        the port's client raises as `DeviceFlushFailed`."""
        while not self._stop.is_set():
            try:
                job = self._jobs.get(timeout=0.5)
            except queue.Empty:
                continue
            if job is None:
                return
            batch = [job]
            lanes = len(job.pubs)
            # coalesce whatever arrives within the flush window, up to
            # the bucket capacity
            deadline = _now() + self.flush_s
            drain = False
            while lanes < self.bucket:
                try:
                    nxt = self._jobs.get(timeout=max(
                        0.0, deadline - _now()))
                except queue.Empty:
                    break
                if nxt is None:
                    drain = True
                    break
                batch.append(nxt)
                lanes += len(nxt.pubs)
            try:
                self._flush(batch)
            except Exception as e:  # noqa: BLE001 — answer, survive
                self.stats["flush_failures"] += 1
                for j in batch:
                    try:
                        with j.lock:
                            send_frame(j.sock,
                                       encode_flush_failed(j.req_id))
                    except OSError:
                        pass
                print(f"device server: flush failed "
                      f"({type(e).__name__}: {e}); batch answered "
                      f"FLUSH_FAILED", flush=True)
            if drain:
                return

    def _unprocessable(self, pubs: List[bytes], msgs: List[bytes]
                       ) -> bool:
        """Reject what the compiled bucket cannot serve. Canary lanes
        (device/health) ride ON TOP of a caller's bucket-sized payload,
        so the lane cap grants them headroom — without it, a batch that
        exactly filled the bucket before canaries would bounce as
        UNPROCESSABLE and trip the supervisor into a SUSPECT/HEALTHY
        flap. verify_batch chunks past the bucket; the kernel shape
        never changes."""
        return (any(len(m) > self.max_msg_len for m in msgs)
                or len(pubs) > self.bucket + CANARY_LANES)

    # --- socket side ----------------------------------------------------------

    def _serve_conn(self, sock: socket.socket) -> None:
        wlock = threading.Lock()
        with self._conns_lock:
            self._conns.add(sock)
        try:
            while not self._stop.is_set():
                payload = recv_frame(sock)
                req_id, pubs, msgs, sigs = decode_request(payload)
                ids = decode_request_trace(payload)
                ctx = TraceContext(*ids) if ids is not None else None
                self.stats["requests"] += 1
                # oversized messages / batches can't ride the compiled
                # bucket: answer UNPROCESSABLE (zero lanes for a
                # nonzero request — distinct from per-lane failure, so
                # clients fall back locally instead of treating valid
                # signatures as forged)
                if self._unprocessable(pubs, msgs):
                    with wlock:
                        send_frame(sock, encode_response(
                            req_id, False, []))
                    continue
                self._jobs.put(_Job(sock, wlock, req_id, pubs, msgs,
                                    sigs, ctx))
        except (ConnectionError, OSError, ValueError):
            pass  # garbage or lost peer: drop the connection cleanly
        finally:
            with self._conns_lock:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def start(self) -> None:
        self._warm()
        self._spawn(self._device_routine, "device-flush")

        def accept_loop():
            while not self._stop.is_set():
                try:
                    sock, _ = self._listener.accept()
                except OSError:
                    return
                self._spawn(self._serve_conn, "device-conn", sock)

        self._spawn(accept_loop, "device-accept")

    def _spawn(self, target, name: str, *args) -> None:
        t = threading.Thread(target=target, name=name, args=args,
                             daemon=True)
        self._threads.append(t)
        t.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop serving: the flush thread finishes the batch it holds,
        the listener and every open connection close, and each thread
        is joined (up to `timeout` seconds in all), so none outlives
        the server."""
        self._stop.set()
        self._jobs.put(None)
        with self._conns_lock:
            socks = [self._listener, *self._conns]
        for sock in socks:
            try:
                # shutdown wakes a thread blocked in accept() or recv()
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        deadline = _now() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - _now()))


def _now() -> float:
    # deliberately wall clock: the device server is a standalone
    # process whose batch deadlines track real elapsed time; simnet
    # never runs it in-process (stub backends stand in for it)
    import time
    return time.monotonic()  # staticcheck: allow(wallclock)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="device-server")
    ap.add_argument("--laddr", default="127.0.0.1:28657")
    ap.add_argument("--bucket", type=int, default=1024)
    ap.add_argument("--max-msg-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device the flushes run on (default cuda)")
    args = ap.parse_args(argv)
    host, _, port = args.laddr.rpartition(":")
    srv = DeviceServer(host or "127.0.0.1", int(port),
                       bucket=args.bucket,
                       max_msg_len=args.max_msg_len, device=args.device)
    srv.start()
    import torch
    what = (torch.cuda.get_device_name(srv.device)
            if srv.device.type == "cuda" else str(srv.device))
    print(f"device server on {srv.addr} device={what} "
          f"bucket={srv.bucket}", flush=True)
    try:
        import time
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

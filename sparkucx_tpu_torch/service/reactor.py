"""Shared event-loop serving plane: one selector, a bounded worker pool.

Copy of ``sparkucx_tpu/service/reactor.py``.

The historical serving planes spawn a thread per accepted connection
(shuffle/daemon.py, transport/peer.py BlockServer) — fine for a handful of
reducers, a non-starter for production fan-in where thousands of reducers
hold idle connections between fetch windows.  This reactor holds every idle
connection in ONE ``selectors`` event loop and only occupies a worker thread
while a connection actually has a frame to serve:

* the loop thread ``select()``\\ s over all registered sockets,
* a readable listener accepts (drains the accept queue) and hands each new
  connection to the owner's ``on_accept`` callback, which registers it,
* a readable connection is *unregistered* and a ``serve_once(conn)`` task is
  submitted to the bounded pool; the task reads exactly one frame with the
  owner's existing blocking frame reader, dispatches it, and returns True to
  re-arm the connection (or False to drop it),
* re-arming goes back through the loop thread (a self-pipe wakes the
  ``select``), so selector mutation stays single-threaded.

Because readiness is edge-driven per frame, a connection is never owned by
two workers at once, and the owner's per-connection serve code runs unchanged
— same blocking reads, same timeouts, same error handling — just multiplexed
over ``workers`` threads instead of one thread per connection.
"""

from __future__ import annotations

import selectors
import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

#: Pool size used when the reactor is requested (tenants.enabled) but
#: ``server.workers`` was left at 0.
DEFAULT_WORKERS = 8


class Reactor:
    """Selector loop + bounded worker pool for frame-at-a-time serving."""

    def __init__(
        self,
        workers: int = 0,
        name: str = "sparkucx-reactor",
        accept_backlog: int = 0,
    ) -> None:
        self.workers = int(workers) if workers and workers > 0 else DEFAULT_WORKERS
        #: Load-shedding bound (``server.acceptBacklog``): with more than this
        #: many resident connections, new accepts get a best-effort ServerBusy
        #: frame and an immediate close instead of queueing unboundedly.
        #: 0 = off (accept everything), the byte-identical default.
        self.accept_backlog = int(accept_backlog)
        self._sel = selectors.DefaultSelector()
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix=f"{name}-worker"
        )
        # Self-pipe: worker threads and external callers wake the select() to
        # apply selector mutations on the loop thread.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None, None))
        self._pending: List[Tuple] = []  #: guarded by self._lock
        self._conns: Dict[socket.socket, Tuple] = {}  #: guarded by self._lock
        self._listeners: List[socket.socket] = []  #: guarded by self._lock
        self._closed = False  #: guarded by self._lock
        self._frames_served = 0  #: worker-pool dispatches; guarded by self._lock
        self._sheds = 0  #: connections shed over accept_backlog; guarded by self._lock
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    # -- registration ---------------------------------------------------
    def add_listener(self, sock: socket.socket, on_accept: Callable[[socket.socket], None]) -> None:
        """Serve accepts from ``sock`` (made non-blocking) on the loop thread;
        ``on_accept(conn)`` must register the new connection (cheaply)."""
        sock.setblocking(False)
        with self._lock:
            if self._closed:
                raise RuntimeError("reactor is closed")
            self._listeners.append(sock)
            self._pending.append(("listener", sock, on_accept, None))
        self._wake()

    def add_connection(
        self,
        conn: socket.socket,
        serve_once: Callable[[socket.socket], bool],
        on_close: Optional[Callable[[socket.socket], None]] = None,
    ) -> None:
        """Arm ``conn``: next readable event submits ``serve_once(conn)`` to
        the pool.  ``serve_once`` returns True to re-arm, False to drop (then
        ``on_close(conn)`` runs and the socket is closed)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("reactor is closed")
            self._conns[conn] = (serve_once, on_close)
            self._pending.append(("conn", conn, serve_once, on_close))
        self._wake()

    def drop_connection(self, conn: socket.socket) -> None:
        """Forget a connection without closing it (the owner took it over)."""
        with self._lock:
            self._conns.pop(conn, None)
            self._pending.append(("forget", conn, None, None))
        self._wake()

    @property
    def num_connections(self) -> int:
        with self._lock:
            return len(self._conns)

    def stats(self) -> Dict[str, int]:
        """Serving-plane health for the metrics registry: resident
        connections, pool width, frames dispatched to workers so far."""
        with self._lock:
            return {
                "connections": len(self._conns),
                "workers": self.workers,
                "frames_served": self._frames_served,
                "sheds": self._sheds,
            }

    # -- internals ------------------------------------------------------
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def _apply_pending(self) -> None:
        with self._lock:
            ops, self._pending = self._pending, []
        for kind, sock, a, b in ops:
            try:
                if kind == "listener":
                    self._sel.register(sock, selectors.EVENT_READ, ("listener", a, b))
                elif kind == "conn":
                    self._sel.register(sock, selectors.EVENT_READ, ("conn", a, b))
                elif kind == "forget":
                    try:
                        self._sel.unregister(sock)
                    except (KeyError, ValueError):
                        pass
            except (KeyError, ValueError, OSError):
                # Socket died between queueing and registration; the worker
                # that owned it already ran its close path.
                continue

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    break
            self._apply_pending()
            try:
                events = self._sel.select(timeout=0.5)
            except OSError:
                continue
            for key, _ in events:
                kind, a, b = key.data
                if kind == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                elif kind == "listener":
                    self._drain_accepts(key.fileobj, a)
                else:  # conn
                    try:
                        self._sel.unregister(key.fileobj)
                    except (KeyError, ValueError):
                        pass
                    self._pool.submit(self._serve, key.fileobj, a, b)

    def _drain_accepts(self, sock: socket.socket, on_accept) -> None:
        while True:
            try:
                conn, _ = sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self.accept_backlog > 0:
                with self._lock:
                    shed = len(self._conns) >= self.accept_backlog
                    if shed:
                        self._sheds += 1
                if shed:
                    self._shed(conn)
                    continue
            try:
                on_accept(conn)
            except Exception:
                try:
                    conn.close()
                except OSError:
                    pass

    @staticmethod
    def _shed(conn: socket.socket) -> None:
        """Refuse an over-backlog connection with a typed busy reply.

        Runs ON the loop thread, so it must never block: the ServerBusy frame
        goes out best-effort on a non-blocking socket (20 bytes fits any sane
        send buffer) and the connection closes either way.  Clients surface
        the frame — or the bare reset — as a retryable condition.
        """
        from sparkucx_tpu_torch.core.definitions import AmId, pack_frame

        try:
            conn.setblocking(False)
            conn.send(pack_frame(AmId.SERVER_BUSY))
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def _serve(self, conn: socket.socket, serve_once, on_close) -> None:
        keep = False
        with self._lock:
            self._frames_served += 1
        try:
            keep = bool(serve_once(conn))
        except Exception:
            keep = False
        with self._lock:
            closed = self._closed
            if not keep or closed:
                self._conns.pop(conn, None)
        if keep and not closed:
            with self._lock:
                self._pending.append(("conn", conn, serve_once, on_close))
            self._wake()
            return
        if on_close is not None:
            try:
                on_close(conn)
            except Exception:
                pass
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """Stop the loop, drain workers, close every held socket."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wake()
        me = threading.current_thread()
        if me is not self._thread:
            self._thread.join(timeout=5)
        # close() can arrive FROM a pool worker (a served frame asked the
        # owner to shut down) — waiting would self-join that worker
        self._pool.shutdown(wait=me not in getattr(self._pool, "_threads", ()))
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
            listeners, self._listeners = self._listeners, []
        for sock in conns + listeners:
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError, OSError):
            pass
        self._wake_r.close()
        self._wake_w.close()
        self._sel.close()

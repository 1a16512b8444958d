"""The engine's wire loop in-process, and the closed-loop clients that drive it.

:class:`PipeClient` is ``chip_smoke.py``'s: ``EngineServer`` (``engine_cli
serve``'s loop) on a thread over in-memory pipes. One reader thread hands
each reply to the client waiting on its ``request_id``. Each client sends
its next request when its reply has been read; a request's latency is the
client's wall from writing its line to reading its reply.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

REPLY_TIMEOUT_S = 300.0


class WireError(RuntimeError):
    pass


class PipeClient:
    """``EngineServer(hooks)`` on a thread, over in-memory pipes."""

    def __init__(self, hooks):
        from light_whisper_tpu_torch.runtime.server import EngineServer

        r_in, w_in = os.pipe()
        r_out, w_out = os.pipe()
        self._to_server = os.fdopen(w_in, "w", encoding="utf-8")
        self._from_server = os.fdopen(r_out, "r", encoding="utf-8")
        server_in = os.fdopen(r_in, "r", encoding="utf-8")
        server_out = os.fdopen(w_out, "w", encoding="utf-8")
        self.server = EngineServer(hooks, stdin=server_in, stdout=server_out)

        def run():
            try:
                self.server.run()
            finally:
                server_out.close()
                server_in.close()

        self.thread = threading.Thread(target=run, name="engine-server", daemon=True)
        self.thread.start()
        self._write_lock = threading.Lock()
        self._waiters: Dict[int, "_Pending"] = {}
        self._waiters_lock = threading.Lock()
        self._reader: Optional[threading.Thread] = None

    def read(self) -> dict:
        line = self._from_server.readline()
        if not line:
            raise WireError("engine server closed its output")
        return json.loads(line)

    def write(self, line: str) -> None:
        with self._write_lock:
            self._to_server.write(line)
            self._to_server.flush()

    # -- pipelined requests ------------------------------------------------

    def start_reader(self) -> None:
        """From here on replies go to the waiters by ``request_id``."""

        def run():
            while True:
                line = self._from_server.readline()
                t = time.perf_counter()
                if not line:
                    break
                reply = json.loads(line)
                with self._waiters_lock:
                    pending = self._waiters.pop(reply.get("request_id"), None)
                if pending is not None:
                    pending.reply, pending.t_reply = reply, t
                    pending.done.set()
            with self._waiters_lock:
                for pending in self._waiters.values():
                    pending.done.set()

        self._reader = threading.Thread(target=run, name="wire-reader", daemon=True)
        self._reader.start()

    def call(self, command: dict, rid: int) -> dict:
        pending = self.submit(json.dumps({**command, "request_id": rid}) + "\n", rid)
        return pending.wait()

    def submit(self, line: str, rid: int) -> "_Pending":
        pending = _Pending()
        with self._waiters_lock:
            self._waiters[rid] = pending
        pending.t_sent = time.perf_counter()
        self.write(line)
        return pending

    def close(self) -> None:
        try:
            self.write(json.dumps({"action": "exit", "request_id": 0}) + "\n")
        except (OSError, ValueError):
            pass
        self._to_server.close()
        self.thread.join(timeout=120)
        if self._reader is not None:
            self._reader.join(timeout=30)
        if self.thread.is_alive():
            raise WireError("engine server thread did not stop")
        self._from_server.close()


class _Pending:
    __slots__ = ("done", "reply", "t_sent", "t_reply")

    def __init__(self):
        self.done = threading.Event()
        self.reply: Optional[dict] = None
        self.t_sent = self.t_reply = 0.0

    def wait(self) -> dict:
        if not self.done.wait(REPLY_TIMEOUT_S) or self.reply is None:
            raise WireError("no reply within the time limit")
        return self.reply


@dataclasses.dataclass
class Request:
    client: int
    utterance: int
    rid: int
    t_sent: float
    t_reply: float = 0.0
    reply: Optional[dict] = None
    steps: Optional[list] = None  # the decode steps' host walls, where the path's list was reachable
    tokens: Optional[list] = None  # the served ids the reply's text names


def transcribe_line(rid: int, stream: str, payload: str) -> str:
    return ('{"action": "transcribe", "request_id": %d, "options": {"stream": "%s"}, '
            '"audio_format": "pcm_s16le", "sample_rate": 16000, "audio_base64": "%s"}\n' % (rid, stream, payload))


class ClosedLoop:
    """``clients`` threads, each on its own named stream, each sending the
    next utterance of its order when its reply is in. :meth:`pause` holds
    every client before its next send and waits until nothing is in flight;
    :meth:`resume` lets them go on."""

    def __init__(self, wire: PipeClient, traffic, stream_prefix: str, first_rid: int,
                 on_reply: Callable[[Request], None]):
        self.wire, self.traffic, self.prefix = wire, traffic, stream_prefix
        self.on_reply = on_reply
        self._rid = first_rid
        self._rid_lock = threading.Lock()
        self.requests: List[Request] = []
        self._lock = threading.Lock()
        self._open = True
        self.inflight = 0
        self._idle = threading.Condition()
        self.errors: List[BaseException] = []

    def _next_rid(self) -> int:
        with self._rid_lock:
            self._rid += 1
            return self._rid

    def stream(self, client: int) -> str:
        return f"{self.prefix}{client}"

    def _client(self, c: int, stop_at: float, sends: Optional[int]) -> None:
        order = self.traffic.orders[c]
        i = 0
        try:
            while (sends is None and time.perf_counter() < stop_at) or (sends is not None and i < sends):
                with self._idle:
                    while not self._open:
                        self._idle.wait()
                    if sends is None and time.perf_counter() >= stop_at:
                        break
                    self.inflight += 1
                u = order[i % len(order)]
                i += 1
                rid = self._next_rid()
                pending = self.wire.submit(transcribe_line(rid, self.stream(c), self.traffic.payloads[u]), rid)
                req = Request(c, u, rid, pending.t_sent)
                try:
                    req.reply = pending.wait()
                    req.t_reply = pending.t_reply
                    self.on_reply(req)
                    with self._lock:
                        self.requests.append(req)
                finally:
                    with self._idle:
                        self.inflight -= 1
                        self._idle.notify_all()
        except BaseException as exc:  # surfaced by run(): a client thread must not die silently
            self.errors.append(exc)

    def pause(self) -> None:
        with self._idle:
            self._open = False
            while self.inflight > 0:
                self._idle.wait()

    def resume(self) -> None:
        with self._idle:
            self._open = True
            self._idle.notify_all()

    def run(self, seconds: Optional[float] = None, sends: Optional[int] = None,
            during: Optional[Callable[["ClosedLoop", float], None]] = None) -> float:
        """Run until ``seconds`` have passed (or each client has made ``sends``
        requests), then until every request in flight has its reply. Returns
        the start time; ``during(self, start)`` runs on the calling thread."""
        start = time.perf_counter()
        stop_at = start + (seconds if seconds is not None else float("inf"))
        threads = [threading.Thread(target=self._client, args=(c, stop_at, sends), name=f"client-{c}", daemon=True)
                   for c in range(self.traffic.clients)]
        for t in threads:
            t.start()
        if during is not None:
            during(self, start)
        for t in threads:
            t.join(timeout=(seconds or 0) + 2 * REPLY_TIMEOUT_S)
        if any(t.is_alive() for t in threads):
            raise WireError("a client did not finish")
        if self.errors:
            raise self.errors[0]
        return start

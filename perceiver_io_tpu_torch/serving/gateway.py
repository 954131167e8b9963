"""Async HTTP/SSE streaming gateway: the serving stack's network front
end. Counterpart of ``perceiver_io_tpu/serving/gateway.py`` (host code,
copied).

:class:`StreamingGateway` is a stdlib-only (``asyncio``) HTTP/1.1 server
that multiplexes concurrent connections onto one engine, either engine or a
whole :class:`~perceiver_io_tpu_torch.serving.fleet.FleetRouter`, driven
through the shared request surface from a single driver task:

- ``POST /v1/generate``: body ``{"prompt": str | "prompt_ids": [int],
  "max_new_tokens"?: int, "stream"?: "sse"|"jsonl", "deadline_s"?: s,
  "priority"?: int in [-100, 100], "tenant"?: str}``. Each token is flushed
  as the engine's ``step()`` materialises it (the request's ``on_token``
  sink; batch-granular on the bucket engine), framed as Server-Sent Events
  (``data: {...}``) or JSON lines, the stream ending in ``{"done": true,
  "status": ..., "trace_id": ...}``.
- ``GET /healthz``: the engine's health snapshot; 200 while ``ready``,
  503 otherwise.
- ``GET /metrics``: the registry in Prometheus text format.

**Socket-anchored TTFT.** The accept instant goes to
``submit(ttft_anchor_s=...)``, so ``serving_ttft_ms`` includes the
gateway's queue time (the fleet carries the anchor through failover
replays); ``gateway_socket_ttft_ms`` measures accept to the first token
byte written to the socket.

**Cancellation.** A client disconnect (socket EOF, a failed write, or a
``gateway.disconnect.<stream>`` chaos fault) becomes ``engine.cancel``:
the slot frees and every pool page returns tagged ``cancelled``, without
moving the surviving streams' tokens. A burst of disconnects feeds the
flight recorder's ``mass_disconnect`` trigger through
:class:`~perceiver_io_tpu_torch.observability.DisconnectWatch`. Every
accepted stream ends one way: ``gateway_streams_completed_total +
gateway_streams_cancelled_total == gateway_streams_total``.

**Threads.** :meth:`StreamingGateway.run_in_thread` steps the engine from
the event loop's own thread, so the engine's kernels launch from there:
the engine places every tensor on its own ``device``, and the caller builds
the kernels and warms the engine before the gateway starts, and does not
touch the engine while it runs. On fleet failover the replayed copy
re-emits indices from 0; the per-stream ``sent`` cursor dedupes them.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from perceiver_io_tpu_torch.observability.timeline import tenant_label
from perceiver_io_tpu_torch.reliability import QueueFull

#: stream framings the gateway speaks
STREAM_MODES = ("sse", "jsonl")

#: request-body cap — a generate request is a prompt plus a few scalars;
#: anything bigger is a malformed or hostile client (answered 413, never
#: buffered)
MAX_BODY_BYTES = 1 << 20

#: counters declared at construction so exports show the full gateway
#: schema before the first connection (docs/observability.md)
GATEWAY_COUNTERS = (
    "gateway_connections_total",
    "gateway_streams_total",
    "gateway_streams_completed_total",
    "gateway_streams_cancelled_total",
    "gateway_streams_rejected_total",
    "gateway_bytes_sent_total",
)

_CONTENT_TYPES = {"sse": "text/event-stream", "jsonl": "application/x-ndjson"}


@dataclasses.dataclass
class _Stream:
    """Host-side record of one in-flight token stream: the engine handle,
    the per-stream token queue the ``on_token`` sink feeds, and the wire
    cursor (``sent``) that dedupes failover replays."""

    stream_id: int
    handle: object  # ServeRequest | FleetRequest
    queue: "asyncio.Queue"
    accepted_at: float
    mode: str = "sse"
    sent: int = 0
    bytes_sent: int = 0
    disconnected: bool = False
    finalized: bool = False  # terminal sentinel enqueued
    #: the stream reached exactly one of completed/cancelled — the
    #: disposition invariant's bookkeeping bit (a handler torn down by
    #: server shutdown settles in its finally block)
    counted: bool = False


class StreamingGateway:
    """Asyncio HTTP/1.1 front end over one engine or fleet (module
    docstring for the protocol).

    :param engine: anything with the shared request surface — ``submit`` /
        ``step`` / ``pending`` / ``cancel`` / ``health`` / ``drain`` (both
        engines and the :class:`~perceiver_io_tpu_torch.serving.FleetRouter`).
        The gateway becomes the engine's single driver: nothing else may
        call ``step()`` while it runs.
    :param host / port: bind address; ``port=0`` picks an ephemeral port
        (read it back from :attr:`port` after :meth:`run_in_thread`).
    :param stream: default framing, ``"sse"`` or ``"jsonl"`` (per-request
        override via the body's ``"stream"`` field).
    :param encode / decode: optional tokenizer hooks. ``encode(str) ->
        ids`` enables the ``"prompt"`` text field; ``decode([id]) -> str``
        adds a ``"text"`` field to every token record. Without ``encode``,
        only ``"prompt_ids"`` is accepted.
    :param registry: metrics registry for the ``gateway_*`` families;
        defaults to the engine's own registry so one scrape covers both.
    :param tracer: optional span tracer — one ``gateway.request`` event
        per stream on the request's trace (the events.jsonl join).
    :param chaos: optional :class:`~perceiver_io_tpu_torch.reliability.ChaosRegistry`
        consulted at ``gateway.disconnect.<stream>`` once per outgoing
        token — the scripted mass-abandonment drill.
    :param clock: monotonic time source shared with the engine (the TTFT
        anchor and the engine's latency accounting must share a time base).
    :param slo_monitor: optional
        :class:`~perceiver_io_tpu_torch.observability.SLOMonitor`, polled once
        per driver pass (skipped when the engine is a fleet — the router
        polls its own monitor inside ``step()``).
    :param snapshot_writer: optional cadence-gated
        :class:`~perceiver_io_tpu_torch.observability.SnapshotWriter`, offered a
        write once per driver pass.
    :param max_streams: shut the server down after this many streams reach
        a terminal state (None = serve until :meth:`close`) — the CLI's
        scriptable-run knob.
    :param idle_sleep_s: driver nap while the engine has no pending work.
    """

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 stream: str = "sse",
                 encode: Optional[Callable] = None,
                 decode: Optional[Callable] = None,
                 registry=None, tracer=None, chaos=None,
                 clock: Callable[[], float] = time.monotonic,
                 slo_monitor=None, snapshot_writer=None,
                 flight_recorder=None,
                 max_streams: Optional[int] = None,
                 idle_sleep_s: float = 0.002,
                 mass_disconnect_threshold: int = 3,
                 mass_disconnect_window_s: float = 5.0):
        if stream not in STREAM_MODES:
            raise ValueError(
                f"stream must be one of {STREAM_MODES}, got {stream!r}"
            )
        if max_streams is not None and max_streams < 1:
            raise ValueError(f"max_streams must be >= 1, got {max_streams}")
        self.engine = engine
        self.host = host
        self.port = int(port)  # rebound to the real port after start()
        self.stream_mode = stream
        self._encode = encode
        self._decode = decode
        self.registry = registry if registry is not None else engine.registry
        self.tracer = tracer
        self._chaos = chaos
        self._clock = clock
        self.slo_monitor = slo_monitor
        self.snapshot_writer = snapshot_writer
        #: optional incident
        #: :class:`~perceiver_io_tpu_torch.observability.FlightRecorder` —
        #: ``mass_disconnect_threshold`` client disconnects inside
        #: ``mass_disconnect_window_s`` fire its ``mass_disconnect`` seam
        #: (docs/observability.md "Flight recorder & incident bundles"):
        #: one abandoned stream is churn, a burst is an incident
        self.flight_recorder = flight_recorder
        from perceiver_io_tpu_torch.observability.flight_recorder import DisconnectWatch

        self._disconnect_watch = DisconnectWatch(
            threshold=mass_disconnect_threshold,
            window_s=mass_disconnect_window_s, clock=clock,
        )
        #: accepted streams per sanitized tenant label (the wire half of
        #: the per-tenant attribution the engines carry in their stats())
        self._streams_by_tenant: Dict[str, int] = {}
        self.max_streams = max_streams
        self.idle_sleep_s = float(idle_sleep_s)
        # the fleet router polls its own monitor per step(); polling it
        # here too would double-diff the disposition counters
        self._poll_slo = (
            slo_monitor is not None
            and getattr(engine, "slo_monitor", None) is not slo_monitor
        )
        self.registry.declare_counters(*GATEWAY_COUNTERS)
        self.registry.set_gauge("gateway_connections_active", 0)
        self.registry.set_gauge("gateway_streams_active", 0)
        self._streams: Dict[int, _Stream] = {}  # engine request id -> stream
        self._next_stream_id = 1
        self._finished_streams = 0
        self._active_connections = 0
        self.driver_errors: List[str] = []
        self._server = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._stopping = False
        self._startup_error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        """Bind the listening socket (call from the serving event loop)."""
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve(self) -> None:
        """Run the driver + server until :meth:`close` (or ``max_streams``)
        stops it. ``start()`` must have run. (``run_in_thread`` creates
        ``_stop_event`` BEFORE signalling readiness, so an immediate
        ``close()`` from the caller is never a lost wakeup.)"""
        if self._stop_event is None:
            self._stop_event = asyncio.Event()
        driver = asyncio.ensure_future(self._drive())
        try:
            await self._stop_event.wait()
        finally:
            self._stopping = True
            driver.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await driver
            self._server.close()
            # bounded wait only: on Python >= 3.12.1 wait_closed() blocks
            # until every connection HANDLER returns, and a handler mid-
            # stream (its client still connected, its terminal sentinel
            # never coming — the driver is dead) would deadlock shutdown.
            # Handlers left running are cancelled when the loop exits;
            # their finally blocks settle the disposition invariant
            # (cancel the engine request + count the stream).
            with contextlib.suppress(asyncio.TimeoutError, TimeoutError):
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)

    def run_in_thread(self) -> "StreamingGateway":
        """Start the gateway on its own event loop in a daemon thread and
        return once the socket is bound (``self.port`` is then real). The
        engine is driven ONLY from that thread — the single-owner contract
        holds; callers interact over HTTP (or via :meth:`close`)."""
        started = threading.Event()

        async def _main():
            try:
                await self.start()
            except BaseException as e:  # bind failure -> surface in caller
                self._startup_error = e
                started.set()
                return
            self._loop = asyncio.get_running_loop()
            # the stop event must exist before the caller unblocks: a
            # close() issued right after run_in_thread() returns has to
            # find something to set, or it would silently leak the thread
            self._stop_event = asyncio.Event()
            started.set()
            await self.serve()

        self._thread = threading.Thread(
            target=lambda: asyncio.run(_main()), daemon=True,
            name="perceiver-gateway",
        )
        self._thread.start()
        if not started.wait(timeout=30.0):
            raise RuntimeError("gateway failed to start within 30s")
        if self._startup_error is not None:
            raise RuntimeError(
                f"gateway failed to bind {self.host}:{self.port}: "
                f"{self._startup_error}"
            )
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the gateway thread exits (``max_streams`` reached or
        :meth:`close` called elsewhere); returns False on timeout."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def close(self) -> None:
        """Stop the server and driver; idempotent, thread-safe. In-flight
        streams are torn down with the loop; the ENGINE keeps its state —
        the caller decides whether to ``drain()`` or ``cancel`` leftovers."""
        loop = self._loop
        if loop is not None and self._stop_event is not None:
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(self._stop_event.set)
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=10.0)

    # -- the driver ----------------------------------------------------------
    async def _drive(self) -> None:
        """THE engine drive loop: one ``step()`` per pass while work is
        pending, then a flush of newly-terminal streams. Runs in the same
        event loop as every connection handler, so ``on_token`` sinks
        (plain ``put_nowait``) and ``cancel()`` calls never race the
        scheduler — asyncio's cooperative scheduling is the lock."""
        while not self._stopping:
            worked = False
            if self.engine.pending():
                try:
                    self.engine.step()
                    worked = True
                except Exception as e:  # engine isolates its own faults;
                    # a scheduler bug must not kill every open connection —
                    # but a PERSISTENT fault (pending stays true, step keeps
                    # raising) must not hot-spin the loop either: leave
                    # worked False so the pass backs off by idle_sleep_s,
                    # and bound the error log
                    if len(self.driver_errors) < 100:
                        self.driver_errors.append(f"{type(e).__name__}: {e}")
            if self._poll_slo:
                self.slo_monitor.poll()
            if self.snapshot_writer is not None:
                self.snapshot_writer.maybe_write()
            if self.flight_recorder is not None:
                # the flight recorder's periodic "before" evidence rides
                # the same per-pass cadence hook as the snapshot writer
                self.flight_recorder.maybe_record()
            self._flush_terminal()
            # yield so handlers drain their queues between steps; nap when
            # idle instead of hot-spinning the loop
            await asyncio.sleep(0 if worked else self.idle_sleep_s)

    def _flush_terminal(self) -> None:
        """Enqueue the terminal sentinel for every stream whose engine
        handle reached a terminal state since the last pass."""
        for stream in list(self._streams.values()):
            if not stream.finalized and stream.handle.done:
                stream.finalized = True
                stream.queue.put_nowait(None)

    # -- http plumbing -------------------------------------------------------
    async def _read_http(self, reader):
        request_line = await reader.readline()
        if not request_line:
            return None
        parts = request_line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, value = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        body = b""
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            return None  # malformed head: drop the connection, nothing to answer
        if length > MAX_BODY_BYTES:
            # don't buffer an attacker-sized body; body=None marks oversize
            return method, path, headers, None
        if length > 0:
            body = await reader.readexactly(length)
        return method, path, headers, body

    async def _write(self, writer, data: bytes,
                     stream: Optional[_Stream] = None) -> bool:
        """One counted socket write; False when the peer is gone."""
        try:
            writer.write(data)
            await writer.drain()
        except (ConnectionError, OSError):
            return False
        self.registry.inc("gateway_bytes_sent_total", len(data))
        if stream is not None:
            stream.bytes_sent += len(data)
        return True

    async def _respond(self, writer, status: int, payload: dict,
                       extra_headers: str = "") -> None:
        """One-shot JSON response (errors, healthz) with Content-Length.
        ``extra_headers`` is pre-formatted ``Name: value\\r\\n`` lines."""
        body = (json.dumps(payload, default=str) + "\n").encode()
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            "Content-Type: application/json\r\n"
            f"{extra_headers}"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin-1")
        await self._write(writer, head + body)

    async def _on_connection(self, reader, writer) -> None:
        self.registry.inc("gateway_connections_total")
        self._active_connections += 1
        self.registry.set_gauge(
            "gateway_connections_active", self._active_connections
        )
        try:
            parsed = await self._read_http(reader)
            if parsed is None:
                return
            method, path, headers, body = parsed
            if body is None:  # oversized Content-Length, never buffered
                await self._respond(
                    writer, 413,
                    {"error": f"request body exceeds {MAX_BODY_BYTES} bytes"},
                )
            elif path == "/healthz" and method == "GET":
                health = self.engine.health()
                # uniform LB payload (docs/serving.md "Elasticity"): a
                # fleet reports its real replica counts (pinned to stay
                # 200-ready across rolling restarts and autoscale
                # transitions); a single engine is its own fleet of one
                health.setdefault("replicas", 1)
                health.setdefault(
                    "replicas_healthy", 1 if health.get("ready") else 0
                )
                health.setdefault(
                    "draining", 0 if health.get("accepting", True) else 1
                )
                await self._respond(
                    writer, 200 if health.get("ready") else 503, health
                )
            elif path == "/metrics" and method == "GET":
                from perceiver_io_tpu_torch.observability import to_prometheus_text

                text = to_prometheus_text(self.registry).encode()
                head = (
                    "HTTP/1.1 200 OK\r\n"
                    "Content-Type: text/plain; version=0.0.4\r\n"
                    f"Content-Length: {len(text)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode("latin-1")
                await self._write(writer, head + text)
            elif path == "/v1/generate":
                if method != "POST":
                    await self._respond(
                        writer, 405, {"error": "use POST /v1/generate"}
                    )
                else:
                    await self._handle_generate(reader, writer, body)
            else:
                await self._respond(writer, 404, {"error": f"no route {path}"})
        except (ConnectionError, OSError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError):
            # the peer vanished mid-request, or sent a head the reader
            # refuses (oversized request/header line past the StreamReader
            # limit raises ValueError/LimitOverrunError): nothing to answer
            pass
        finally:
            self._active_connections -= 1
            self.registry.set_gauge(
                "gateway_connections_active", self._active_connections
            )
            with contextlib.suppress(Exception):
                writer.close()

    # -- the streaming endpoint ----------------------------------------------
    def _base_config(self):
        """The engine's default GenerationConfig — the template per-request
        ``max_new_tokens`` overrides are built from (fleet: replica 0's)."""
        cfg = getattr(self.engine, "config", None)
        if cfg is None and hasattr(self.engine, "replicas"):
            cfg = self.engine.replicas[0].engine.config
        return cfg

    def _max_new_limit(self, base) -> int:
        """Upper bound on a remote ``max_new_tokens`` override: an
        unauthenticated client must not be able to size device buffers —
        cap at a few context lengths (the slot engine additionally rejects
        prompt + max_new past ONE context at submit)."""
        model = getattr(self.engine, "model", None)
        if model is None and hasattr(self.engine, "replicas"):
            model = self.engine.replicas[0].engine.model
        ctx = getattr(model, "max_seq_len", 0) or 0
        return max(4 * ctx, int(base.max_new_tokens), 1)

    def _parse_generate(self, body: bytes):
        """Validated (prompt_ids, config, mode, deadline_s) from the
        request body; raises ValueError with a client-facing message."""
        try:
            payload = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"request body is not valid JSON: {e}")
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        ids = payload.get("prompt_ids")
        if ids is None:
            text = payload.get("prompt")
            if text is None:
                raise ValueError('body needs "prompt" or "prompt_ids"')
            if self._encode is None:
                raise ValueError(
                    'no tokenizer configured: send "prompt_ids" instead of '
                    '"prompt"'
                )
            ids = self._encode(text)
        try:
            prompt = np.asarray(ids, np.int32).reshape(-1)
        except (TypeError, ValueError, OverflowError):
            raise ValueError('"prompt_ids" must be a flat list of token ids')
        mode = payload.get("stream", self.stream_mode)
        if mode not in STREAM_MODES:
            raise ValueError(f'"stream" must be one of {STREAM_MODES}')
        cfg = None
        max_new = payload.get("max_new_tokens")
        if max_new is not None:
            if isinstance(max_new, bool) or not isinstance(max_new, (int, float)):
                raise ValueError('"max_new_tokens" must be a number')
            base = self._base_config()
            if base is None:
                raise ValueError("engine exposes no config to override")
            limit = self._max_new_limit(base)
            if not 1 <= int(max_new) <= limit:
                raise ValueError(
                    f'"max_new_tokens" must be in [1, {limit}] on this '
                    "deployment"
                )
            cfg = dataclasses.replace(base, max_new_tokens=int(max_new))
        deadline_s = payload.get("deadline_s")
        if deadline_s is not None:
            if isinstance(deadline_s, bool) or not isinstance(
                deadline_s, (int, float)
            ):
                raise ValueError('"deadline_s" must be a number of seconds')
            deadline_s = float(deadline_s)
        # scheduling tier + tenant tag (docs/serving.md "Preemption &
        # priorities"): clamped to a small signed range — an
        # unauthenticated client must not be able to claim an unbounded
        # tier any more than it can size device buffers
        priority = payload.get("priority", 0)
        if isinstance(priority, bool) or not isinstance(priority, int):
            raise ValueError('"priority" must be an integer')
        if not -100 <= priority <= 100:
            raise ValueError('"priority" must be in [-100, 100]')
        tenant = payload.get("tenant")
        if tenant is not None:
            if not isinstance(tenant, str) or not tenant or len(tenant) > 128:
                raise ValueError(
                    '"tenant" must be a non-empty string of at most 128 '
                    "characters"
                )
        return prompt, cfg, mode, deadline_s, priority, tenant

    def _event_bytes(self, record: dict, mode: str) -> bytes:
        line = json.dumps(record)
        if mode == "sse":
            return f"data: {line}\n\n".encode()
        return (line + "\n").encode()

    def _cancel_stream(self, stream: _Stream) -> None:
        """Client-disconnect propagation: withdraw the engine request (slot
        + pool pages freed, terminal ``cancelled`` span). A request that
        already finished server-side counts as a completed stream — the
        work was done; only the delivery was abandoned."""
        stream.disconnected = True
        cancelled = False
        try:
            cancelled = self.engine.cancel(stream.handle.request_id)
        except Exception:
            pass
        stream.counted = True
        if cancelled:
            self.registry.inc("gateway_streams_cancelled_total")
            if (
                self.flight_recorder is not None
                and self._disconnect_watch.note()
            ):
                self.flight_recorder.trigger(
                    "mass_disconnect",
                    f"{self._disconnect_watch.threshold} client disconnects "
                    f"within {self._disconnect_watch.window_s}s "
                    f"(stream {stream.stream_id} last)",
                    trace_ids=(
                        [stream.handle.trace_id]
                        if stream.handle.trace_id else []
                    ),
                    stream_id=stream.stream_id,
                    threshold=self._disconnect_watch.threshold,
                    window_s=self._disconnect_watch.window_s,
                )
        else:
            self.registry.inc("gateway_streams_completed_total")

    async def _handle_generate(self, reader, writer, body: bytes) -> None:
        accepted_at = self._clock()  # the socket-accept TTFT anchor
        try:
            prompt, cfg, mode, deadline_s, priority, tenant = \
                self._parse_generate(body)
        except ValueError as e:
            self.registry.inc("gateway_streams_rejected_total")
            await self._respond(writer, 400, {"error": str(e)})
            return
        queue: asyncio.Queue = asyncio.Queue()

        def on_token(index: int, token: int) -> None:
            queue.put_nowait((index, token))

        try:
            handle = self.engine.submit(
                prompt, cfg, deadline_s=deadline_s,
                ttft_anchor_s=accepted_at, on_token=on_token,
                priority=priority, tenant=tenant,
            )
        except QueueFull as e:
            # backpressure maps to 503 + Retry-After: the engine already
            # counted the shed and emitted its terminal span
            self.registry.inc("gateway_streams_rejected_total")
            await self._respond(
                writer, 503,
                {"error": str(e), "trace_id": getattr(e, "trace_id", None)},
                extra_headers="Retry-After: 1\r\n",
            )
            return
        except ValueError as e:
            self.registry.inc("gateway_streams_rejected_total")
            await self._respond(
                writer, 400,
                {"error": str(e), "trace_id": getattr(e, "trace_id", None)},
            )
            return
        except Exception as e:
            # an engine-side bug must answer 500, not kill the handler with
            # a bare connection reset
            self.registry.inc("gateway_streams_rejected_total")
            await self._respond(writer, 500, {"error": f"{type(e).__name__}: {e}"})
            return

        stream = _Stream(
            stream_id=self._next_stream_id, handle=handle, queue=queue,
            accepted_at=accepted_at, mode=mode,
        )
        self._next_stream_id += 1
        self._streams[handle.request_id] = stream
        self.registry.inc("gateway_streams_total")
        # per-tenant wire attribution (docs/observability.md "Scheduler
        # timeline & post-mortems"): accepted streams per sanitized tenant
        # label, rolled up into stats() beside the engine's page/token view
        tkey = tenant_label(tenant)
        self._streams_by_tenant[tkey] = self._streams_by_tenant.get(tkey, 0) + 1
        self.registry.set_gauge("gateway_streams_active", len(self._streams))
        head = (
            "HTTP/1.1 200 OK\r\n"
            f"Content-Type: {_CONTENT_TYPES[mode]}\r\n"
            "Cache-Control: no-cache\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin-1")
        eof_task = asyncio.ensure_future(reader.read())
        try:
            if not await self._write(writer, head, stream):
                self._cancel_stream(stream)
                return
            await self._stream_tokens(writer, stream, eof_task)
        finally:
            if not stream.counted:
                # the handler was torn down mid-stream (server shutdown /
                # max_streams while this one was in flight): settle the
                # disposition invariant — cancel the engine request (its
                # client can never read the rest) and count the stream, so
                # completed + cancelled == accepted still closes
                self._cancel_stream(stream)
            eof_task.cancel()
            with contextlib.suppress(
                asyncio.CancelledError, ConnectionError, OSError
            ):
                await eof_task
            self._streams.pop(handle.request_id, None)
            self.registry.set_gauge(
                "gateway_streams_active", len(self._streams)
            )
            self._finished_streams += 1
            if self.tracer is not None:
                # the stream's one gateway.request event, on the SAME trace
                # as the engine's serving.request span — the events.jsonl
                # join between wire-level and engine-level accounting
                self.tracer.event(
                    "gateway.request",
                    trace_id=getattr(handle, "trace_id", None),
                    stream_id=stream.stream_id, mode=mode,
                    status="cancelled" if stream.disconnected else handle.status,
                    tokens=stream.sent, bytes=stream.bytes_sent,
                )
            if (
                self.max_streams is not None
                and self._finished_streams >= self.max_streams
                and self._stop_event is not None
            ):
                self._stop_event.set()

    async def _stream_tokens(self, writer, stream: _Stream, eof_task) -> None:
        """Pump the stream's token queue onto the socket until the terminal
        sentinel — or the client disconnects (EOF on the read side, a
        failed write, or a scripted ``gateway.disconnect`` fault)."""
        chaos_site = f"gateway.disconnect.{stream.stream_id}"
        while True:
            get_task = asyncio.ensure_future(stream.queue.get())
            done, _ = await asyncio.wait(
                {get_task, eof_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if get_task not in done:
                # the client closed its end before the stream finished
                get_task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await get_task
                self._cancel_stream(stream)
                return
            item = get_task.result()
            if item is None:  # terminal: the engine disposed of the request
                break
            index, token = item
            if index < stream.sent:
                continue  # failover replay: already on the wire
            if self._chaos is not None:
                fault = self._chaos.hit(chaos_site)
                if fault is not None and fault.kind == "error":
                    # scripted abandonment: the client "vanishes" before
                    # this token is written
                    self._cancel_stream(stream)
                    return
            record = {"index": index, "token": int(token)}
            if self._decode is not None:
                try:
                    record["text"] = self._decode([int(token)])
                except Exception:
                    pass  # undecodable id: the raw token still streams
            first = stream.sent == 0
            if not await self._write(
                writer, self._event_bytes(record, stream.mode), stream
            ):
                self._cancel_stream(stream)
                return
            if first:
                self.registry.observe(
                    "gateway_socket_ttft_ms",
                    (self._clock() - stream.accepted_at) * 1e3,
                )
            stream.sent += 1
        handle = stream.handle
        terminal = {
            "done": True,
            "status": handle.status,
            "request_id": handle.request_id,
            "trace_id": getattr(handle, "trace_id", None),
        }
        if handle.error:
            terminal["error"] = handle.error
        # a failed final flush (client gone at the last instant) still
        # counts completed: the server-side work reached a terminal state
        await self._write(writer, self._event_bytes(terminal, stream.mode), stream)
        stream.counted = True
        self.registry.inc("gateway_streams_completed_total")

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        counts = self.registry.counters()

        def c(name: str) -> int:
            return int(counts.get(name, 0))

        return {
            "address": f"{self.host}:{self.port}",
            "stream_mode": self.stream_mode,
            "connections": c("gateway_connections_total"),
            "streams": c("gateway_streams_total"),
            "streams_completed": c("gateway_streams_completed_total"),
            "streams_cancelled": c("gateway_streams_cancelled_total"),
            "streams_rejected": c("gateway_streams_rejected_total"),
            "bytes_sent": c("gateway_bytes_sent_total"),
            "socket_ttft_ms": {
                "p50": self.registry.percentile("gateway_socket_ttft_ms", 50.0),
                "p95": self.registry.percentile("gateway_socket_ttft_ms", 95.0),
            },
            "driver_errors": len(self.driver_errors),
            "streams_by_tenant": dict(sorted(self._streams_by_tenant.items())),
            # prefix sharing (docs/serving.md "Prefix sharing"): a client
            # disconnect's cancellation reclaim is refcount-aware — the
            # cancelled stream's SHARED pages deref (cached prefixes
            # survive for the next hot admission) while its private pages
            # free immediately, both within the cancel instant
            "engine_prefix_cache": getattr(self.engine, "prefix_cache", None),
        }


_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}

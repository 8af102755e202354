"""Minimal HTTP serving layer over :class:`CascadePipeline` (counterpart of
``qaig_tpu/serve.py``).

A load-once/serve-many HTTP endpoint over the port's pipeline: the models
load onto the card (or each card of the pipeline's mesh) at startup and
every request reuses them.  One dispatcher thread runs all of the cards'
work; ``torch.inference_mode``
and the current CUDA device are per-thread state, so the thread sets both
itself.

Concurrent requests COALESCE: a dispatcher thread drains every request
waiting while the device is busy and runs them as ONE padded batch (batch
sizes bucketed to ``batch_multiple * 2^k``, so the pipeline sees
O(log max_batch) shapes, not one per arrival pattern), then splits the
rows back per request.  N concurrent 1-image requests cost ~one cascade
dispatch instead of N full latencies.  Determinism: sampling is ROW-KEYED
(``pipeline.derive_row_keys``) — row ``j`` of a request with seed ``S``
always draws from ``fold_in(key(S), j)`` regardless of what it was
batched with, so the same request returns the same tokens solo and
coalesced (and matches ``pipeline.generate(num, seed=S)``).  Padding rows
use throwaway keys.  ``max_batch`` is rounded down to a ``batch_multiple``
multiple so no padded dispatch exceeds the operator's memory bound.

Endpoints
---------
``GET /healthz``                           liveness -> ``{"status": "ok"}``
``GET /metrics``                           serving counters: requests/images/
    errors totals, dispatch counts (+how many were coalesced), padded-row
    waste, dispatch latency (last/mean/max, and count and seconds per
    padded batch size), queue depth, uptime, and the mesh (``{"data",
    "model", "devices"}``; JSON only).  JSON by
    default; Prometheus text exposition via ``?format=prometheus`` or an
    ``Accept: text/plain`` header (``qaig_``-prefixed gauges)
``POST /reload``                           re-read the checkpoints this
    server was started with (continuous training -> serving refresh): a
    new pipeline is built from the SAME config/decoder paths and swapped
    in atomically between dispatches; in-flight requests finish on the old
    weights.  Note: both weight sets are resident while the reload builds
    (a transient 2x-weights device-memory cost; on failure the old pipeline
    keeps serving).  Requires the server to be constructed with a ``reloader``
    (the CLI wires one).  Responds ``{"status": "reloaded", ...}`` or 503
    while another reload is running.
``POST /generate`` ``{"num_images": N, "seed": S, "return_images": bool,
    "temperature": T}``
    -> ``{"tokens": [[...]], "shape": [...], "images_png_b64": [...]}``
    (images rendered per-sample as PNG, base64; omitted unless requested).
    ``temperature`` (optional, within ``TEMPERATURE_RANGE`` and
    quantized to a 0.1 grid, as in ``qaig_tpu``, where each distinct value
    compiles its own decode programs) overrides every stage's sampling
    temperature for this request; only same-temperature requests
    coalesce.

Backpressure: once ``max_queue_rows`` rows are waiting (default 8 full
dispatches of lag), further requests are shed with **503** +
``Retry-After`` instead of growing the queue without bound; an optional
``request_timeout`` bounds each request's QUEUE wait (**504** on expiry —
a request already merged into a device dispatch always completes).
Both surface in ``/metrics`` as ``rejected_total`` / ``timeouts_total``.

Run: ``python -m qaig_tpu_torch.cli.serve_generation --config-path gen.json
--decoder-path model.pt --port 8000`` (plus ``--bf16`` for serving
precision).
"""

import base64
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from qaig_tpu_torch.infer.pipeline import derive_row_keys
from qaig_tpu_torch.utils import png

# Per-request temperatures are quantized to this grid and range, the
# accepted values of ``qaig_tpu``'s server (<= 50 distinct values).
TEMPERATURE_RANGE = (0.1, 5.0)
TEMPERATURE_GRID_DECIMALS = 1


class ServerOverloadedError(RuntimeError):
    """Pending queue is at its row bound; the request was rejected (503)."""


class RequestTimeoutError(RuntimeError):
    """The request waited in the queue past its deadline (504)."""


def _render_png(image_chw):
    """(C, H, W) float BGR in [-1, 1] -> PNG bytes (RGB, like the grid
    writer's BGR->RGB flip, ``utils/image_io.py``; grey for one
    channel), written by ``utils/png.py``."""
    arr = np.asarray(image_chw, np.float32)
    arr = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return png.encode(arr[::-1].transpose(1, 2, 0))   # RGB HWC


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mesh_of(pipeline):
    """{"data", "model", "devices"} of the pipeline's mesh (one device and
    1 x 1 without one; empty for a pipeline that names no device)."""
    mesh = getattr(pipeline, "mesh", None)
    if mesh is not None:
        return {"data": mesh.size("data"), "model": mesh.size("model"),
                "devices": [[str(d) for d in row] for row in mesh.grid]}
    device = getattr(pipeline, "device", None)
    if device is None:
        return {}
    return {"data": 1, "model": 1, "devices": [[str(device)]]}


class RequestBatcher:
    """Coalesces concurrent generate requests into single device dispatches.

    Handler threads :meth:`submit` and block; one dispatcher thread drains
    everything pending (up to ``max_batch`` rows), pads the merged count up
    to a ``batch_multiple * 2^k`` bucket, runs ONE ``pipeline.generate``
    with PER-REQUEST row keys (each request's rows keyed by its own seed,
    numbered from 0), and hands each caller its slice — a request's tokens
    are independent of its co-batch.
    """

    def __init__(self, pipeline, max_batch=64, batch_multiple=1,
                 max_queue_rows=None, request_timeout=None):
        self.pipeline = pipeline
        self.batch_multiple = max(1, batch_multiple)
        # The operator's memory bound, rounded DOWN to a mesh multiple so a
        # padded dispatch can never exceed it (a ceil-to-multiple fallback
        # used to overshoot max_batch when it wasn't itself a multiple).
        self.max_batch = max(
            self.batch_multiple,
            (max_batch // self.batch_multiple) * self.batch_multiple)
        # Backpressure: reject (503) once this many rows wait in the queue
        # rather than letting latency grow without bound; default = 8 full
        # dispatches of lag, floor = max_batch so any admissible request
        # (num <= max_batch) can always be queued on an idle server — a
        # smaller bound would 503 large requests forever.
        # ``request_timeout`` bounds the QUEUE wait (an in-flight device
        # dispatch is never abandoned — its latency is bounded by
        # max_batch).
        self.max_queue_rows = (8 * self.max_batch if max_queue_rows is None
                               else max(self.max_batch,
                                        int(max_queue_rows)))
        self.request_timeout = request_timeout
        self._cv = threading.Condition()
        self._pending = []
        self._stop = False
        # observability counters (read under _cv via metrics())
        self._stats = {
            "requests_total": 0, "images_total": 0, "errors_total": 0,
            "rejected_total": 0, "timeouts_total": 0, "reloads_total": 0,
            "dispatches_total": 0, "coalesced_dispatches_total": 0,
            "padded_rows_total": 0, "dispatch_seconds_total": 0.0,
            "last_dispatch_seconds": 0.0, "max_dispatch_seconds": 0.0,
        }
        # padded batch size -> {"count", "seconds_total"}
        self._by_batch = {}
        self._started = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def metrics(self):
        """Snapshot of the serving counters (plus queue depth, uptime and
        the pipeline's mesh: its data and model axes and its devices)."""
        with self._cv:
            snap = dict(self._stats)
            snap["mesh"] = _mesh_of(self.pipeline)
            snap["dispatches_by_batch"] = {
                str(size): dict(entry)
                for size, entry in sorted(self._by_batch.items())}
            # same unit as max_queue_rows (rows), plus the request count
            snap["queue_depth"] = sum(r["num"] for r in self._pending)
            snap["queue_requests"] = len(self._pending)
        snap["uptime_seconds"] = round(time.monotonic() - self._started, 3)
        n = max(snap["dispatches_total"], 1)
        snap["mean_dispatch_seconds"] = round(
            snap["dispatch_seconds_total"] / n, 4)
        return snap

    def _bucket(self, total):
        cap = self.batch_multiple
        while cap < total:
            cap *= 2
        if cap > self.max_batch:
            # stay at the memory bound: smallest multiple that fits (total
            # <= max_batch, which is itself a multiple, so this never
            # exceeds max_batch)
            cap = -(-total // self.batch_multiple) * self.batch_multiple
        return cap

    def submit(self, num, seed, temperature=None):
        """Returns (images, tokens) for ``num`` rows; blocks until served.

        ``temperature`` overrides the pipeline's configured sampling
        temperature for this request; only same-temperature requests
        coalesce into one dispatch (one sampler setting per dispatch).

        Raises :class:`ServerOverloadedError` when the pending queue is at
        ``max_queue_rows``, and :class:`RequestTimeoutError` when the
        request waits in the queue past ``request_timeout`` seconds (a
        request already merged into a device dispatch always completes)."""
        item = {"num": num, "seed": seed, "temp": temperature,
                "event": threading.Event(), "result": None, "error": None}
        with self._cv:
            if self._stop:
                # retryable for LB clients during rolling restarts (503)
                raise ServerOverloadedError("server is shutting down")
            depth = sum(r["num"] for r in self._pending)
            if depth + num > self.max_queue_rows:
                self._stats["rejected_total"] += 1
                raise ServerOverloadedError(
                    f"queue full: {depth} rows pending "
                    f"(bound {self.max_queue_rows})")
            self._pending.append(item)
            self._cv.notify()
        if not item["event"].wait(self.request_timeout):
            with self._cv:
                if item in self._pending:  # still queued: cancel cleanly
                    self._pending.remove(item)
                    self._stats["timeouts_total"] += 1
                    raise RequestTimeoutError(
                        f"request timed out after {self.request_timeout}s "
                        f"in queue")
            item["event"].wait()  # in-flight; the dispatch will finish
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def swap_pipeline(self, new_pipeline):
        """Atomically route future dispatches to ``new_pipeline`` (hot
        checkpoint reload); the in-flight dispatch finishes on the old."""
        with self._cv:
            self.pipeline = new_pipeline
            self._stats["reloads_total"] += 1

    def _loop(self):
        # per-thread state: no autograd records, and the pipeline's card
        # (its first replica's, over a mesh: the pipeline makes each
        # replica's card current around its work) as the current CUDA
        # device
        with torch.inference_mode():
            self._dispatch_forever()

    def _dispatch_forever(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
                pipeline = self.pipeline  # stable for this dispatch
                head = self._pending.pop(0)
                batch, total = [head], head["num"]
                # merge every waiting request that shares the head's
                # temperature (one sampler setting per dispatch); others
                # stay queued for later rounds
                i = 0
                while i < len(self._pending):
                    req = self._pending[i]
                    if (req["temp"] == head["temp"]
                            and total + req["num"] <= self.max_batch):
                        self._pending.pop(i)
                        batch.append(req)
                        total += req["num"]
                    else:
                        i += 1
            if len(batch) == 1:
                # solo: padded only as far as the mesh requires (exactly
                # num rows when batch_multiple is 1)
                padded = (-(-batch[0]["num"] // self.batch_multiple)
                          * self.batch_multiple)
            else:
                padded = self._bucket(total)
            t0 = time.monotonic()
            failed = False
            try:
                kwargs = ({} if batch[0]["temp"] is None
                          else {"temperature": batch[0]["temp"]})
                # Row-keyed sampling: request rows keyed by their OWN seed
                # (rows numbered from 0 within the request), padding rows
                # by throwaway keys (row numbers >= 1<<20 so they can't
                # collide with a real request's rows) — result ==
                # pipeline.generate(num, seed) for every request, whatever
                # it was batched with.
                parts = [derive_row_keys(req["seed"], req["num"])
                         for req in batch]
                if padded > total:
                    parts.append(derive_row_keys(0, padded - total,
                                                 start=1 << 20))
                row_keys = torch.cat(parts)
                device = getattr(pipeline, "device", None)
                if device is not None and device.type == "cuda":
                    torch.cuda.set_device(device)
                images, tokens = pipeline.generate(padded,
                                                   row_keys=row_keys,
                                                   **kwargs)
                images, tokens = _to_numpy(images), _to_numpy(tokens)
                offset = 0
                for req in batch:
                    req["result"] = (images[offset:offset + req["num"]],
                                     tokens[offset:offset + req["num"]])
                    offset += req["num"]
            except Exception as e:
                failed = True
                for req in batch:
                    req["error"] = e
            dt = time.monotonic() - t0
            with self._cv:
                s = self._stats
                s["requests_total"] += len(batch)
                s["dispatches_total"] += 1
                if len(batch) > 1:
                    s["coalesced_dispatches_total"] += 1
                s["padded_rows_total"] += padded - total
                s["dispatch_seconds_total"] += dt
                s["last_dispatch_seconds"] = round(dt, 4)
                s["max_dispatch_seconds"] = max(s["max_dispatch_seconds"],
                                                round(dt, 4))
                entry = self._by_batch.setdefault(
                    padded, {"count": 0, "seconds_total": 0.0})
                entry["count"] += 1
                entry["seconds_total"] += dt
                if failed:
                    s["errors_total"] += len(batch)
                else:
                    s["images_total"] += total
            for req in batch:
                req["event"].set()

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)


class GenerationServer:
    """Wraps a :class:`~qaig_tpu_torch.infer.pipeline.CascadePipeline`.

    ``max_batch`` bounds per-request work (memory and latency); concurrent
    requests coalesce through a :class:`RequestBatcher` into single padded
    device dispatches.  ``batch_multiple`` > 1 pads every dispatch to a
    multiple (the data axis of the pipeline's mesh under ``--shard-batch``,
    as in ``qaig_tpu``).
    """

    def __init__(self, pipeline, host="127.0.0.1", port=8000, max_batch=64,
                 batch_multiple=1, max_queue_rows=None, request_timeout=None,
                 reloader=None):
        self.max_batch = max_batch
        self.batch_multiple = max(1, batch_multiple)
        # ``reloader``: zero-arg callable returning a fresh pipeline built
        # from the same on-disk paths; enables POST /reload (hot checkpoint
        # refresh).  One reload at a time.
        self.reloader = reloader
        self._reload_lock = threading.Lock()
        self.batcher = RequestBatcher(pipeline, max_batch=max_batch,
                                      batch_multiple=self.batch_multiple,
                                      max_queue_rows=max_queue_rows,
                                      request_timeout=request_timeout)
        server = self

        class Handler(BaseHTTPRequestHandler):
            # bound every connection's socket reads: an idle/half-open
            # client can otherwise hold a non-daemon handler thread open
            # forever, wedging the graceful drain in server_close()
            timeout = 30

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code, payload, headers=None,
                       content_type="application/json"):
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit
                parts = urlsplit(self.path)
                if parts.path == "/healthz":
                    self._reply(200, {"status": "ok"})
                elif parts.path == "/metrics":
                    snap = server.batcher.metrics()
                    accepts_text = any(
                        part.strip().startswith("text/plain")
                        for part in (self.headers.get("Accept")
                                     or "").split(","))
                    wants_prom = (parse_qs(parts.query).get(
                        "format") == ["prometheus"]) or accepts_text
                    if wants_prom:
                        # Prometheus text exposition, qaig_ prefixed;
                        # monotonic *_total keys are counters
                        lines = []
                        for key, value in sorted(snap.items()):
                            if isinstance(value, bool) or not isinstance(
                                    value, (int, float)):
                                continue
                            kind = ("counter" if key.endswith("_total")
                                    else "gauge")
                            lines.append(f"# TYPE qaig_{key} {kind}")
                            lines.append(f"qaig_{key} {value}")
                        self._reply(
                            200, ("\n".join(lines) + "\n").encode(),
                            content_type="text/plain; version=0.0.4")
                    else:
                        self._reply(200, snap)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/reload":
                    # drain the request body (an unread body + close can
                    # RST the connection before the client reads the reply)
                    self.rfile.read(int(self.headers.get(
                        "Content-Length", 0) or 0))
                    if server.reloader is None:
                        self._reply(400, {
                            "error": "this server was started without a "
                                     "reloader"})
                        return
                    if not server._reload_lock.acquire(blocking=False):
                        self._reply(503, {"error": "reload in progress"},
                                    headers={"Retry-After": "5"})
                        return
                    # only the build is error-guarded: once swap_pipeline
                    # has run, the new weights ARE serving, and a late
                    # reply failure (client gave up during a minutes-long
                    # build) must not be misreported as "reload failed"
                    try:
                        try:
                            new_pipe = server.reloader()
                        except Exception as e:  # old weights keep serving
                            self._reply(500, {
                                "error": f"reload failed, still serving "
                                         f"the previous weights: "
                                         f"{type(e).__name__}: {e}"})
                            return
                        server.batcher.swap_pipeline(new_pipe)
                    finally:
                        server._reload_lock.release()
                    self._reply(200, {"status": "reloaded"})
                    return
                if self.path != "/generate":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    num = int(req.get("num_images", 1))
                    seed = int(req.get("seed", 0))
                    want_images = bool(req.get("return_images", False))
                    temperature = req.get("temperature")
                    if not 1 <= num <= server.batcher.max_batch:
                        self._reply(400, {
                            "error": f"num_images must be in "
                                     f"[1, {server.batcher.max_batch}]"})
                        return
                    if temperature is not None:
                        try:
                            temperature = float(temperature)
                        except (TypeError, ValueError):
                            self._reply(400, {
                                "error": "temperature must be a number"})
                            return
                        lo, hi = TEMPERATURE_RANGE
                        if not (math.isfinite(temperature)
                                and lo <= temperature <= hi):
                            self._reply(400, {
                                "error": f"temperature must be in "
                                         f"[{lo}, {hi}]"})
                            return
                        # grid-quantize, as qaig_tpu does: a bounded set of
                        # temperatures, so requests that differ by noise
                        # still coalesce
                        temperature = round(temperature,
                                            TEMPERATURE_GRID_DECIMALS)
                    # no per-request batch_multiple constraint: the batcher
                    # pads the MERGED batch to a multiple, so any num rows
                    # shard cleanly over the generation mesh
                    images, tokens = server.batcher.submit(
                        num, seed, temperature=temperature)
                    payload = {
                        "tokens": np.asarray(tokens).tolist(),
                        "shape": list(np.asarray(images).shape),
                    }
                    if want_images:
                        payload["images_png_b64"] = [
                            base64.b64encode(_render_png(img)).decode()
                            for img in np.asarray(images)]
                    self._reply(200, payload)
                except ServerOverloadedError as e:  # backpressure: shed load
                    self._reply(503, {"error": str(e)},
                                headers={"Retry-After": "1"})
                except RequestTimeoutError as e:
                    self._reply(504, {"error": str(e)})
                except Exception as e:  # surface as a JSON 500, keep serving
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        class _Server(ThreadingHTTPServer):
            # graceful drain: server_close() waits for handler threads, so
            # every accepted request gets its response before stop() returns
            daemon_threads = False
            block_on_close = True

        self._httpd = _Server((host, port), Handler)
        self._thread = None

    @property
    def pipeline(self):
        """The active pipeline (the batcher owns it; reload swaps it)."""
        return self.batcher.pipeline

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self, background=True):
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()

    def stop(self):
        """Graceful drain: stop accepting, serve the in-flight dispatch and
        everything already queued, wait for the handler threads to write
        their responses, then return."""
        self._httpd.shutdown()      # stop the accept loop
        self.batcher.stop()         # drain pending; submit() calls return
        self._httpd.server_close()  # block_on_close: join handler threads
        if self._thread is not None:
            self._thread.join(timeout=5)

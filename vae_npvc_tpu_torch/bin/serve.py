"""Online voice-conversion HTTP server over the port's ConversionEngine.

Counterpart of ``vae_npvc_tpu/bin/serve.py``: a threaded stdlib HTTP server
whose handler threads submit work to the engine; the engine's batcher
thread owns the GPU.

Endpoints
---------
``GET  /health``                     liveness + checkpoint iteration
``GET  /speakers``                   target-name -> id map
``GET  /stats``                      request/batching counters, p50/p99 of
                                     request latency and of queue wait
``GET  /metrics``                    the same, Prometheus text format, with
                                     both latencies as histograms
``POST /convert?target=NAME``        body = WAV file -> converted WAV
``POST /convert?target=NAME&mel=1``  -> float32 mel matrix (``.npy`` bytes)
``POST /stream?target=NAME&sr=RATE`` body = raw mono PCM (``format=i16``
                                     default, or ``f32``), sent with
                                     ``Transfer-Encoding: chunked`` or a
                                     Content-Length -> chunked streaming-WAV
                                     response (``serve/streaming.py``): mel
                                     frames are computed while audio
                                     arrives, and with ``jpwg`` audio leaves
                                     chunk by chunk; ``&chunk=C&lookahead=L``
                                     (default 64) converts prefixes while
                                     audio arrives (approximate); a mel-only
                                     engine answers with ``.npy`` bytes

Example::

    python -m vae_npvc_tpu_torch.bin.serve --config conf/train_vqvae.yaml \\
        --checkpoint exp/.../model.loss.best --cmvn dump/.../cmvn.ark \\
        --spk2spk_id data/spk2spk_id --port 8080
    curl -s -X POST --data-binary @in.wav \\
        'http://localhost:8080/convert?target=TEF1' -o out.wav
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

logger = logging.getLogger("vae_npvc_tpu_torch.serve.http")


def _prom_num(v):
    """Exact Prometheus number: integers in full, floats at full precision."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _wav_bytes(x, fs):
    from scipy.io import wavfile

    buf = io.BytesIO()
    pcm = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    wavfile.write(buf, int(fs), (pcm * 32767.0).astype(np.int16))
    return buf.getvalue()


def _read_wav_bytes(body):
    from scipy.io import wavfile

    sr, data = wavfile.read(io.BytesIO(body))
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
    elif data.dtype.kind == "u":          # 8-bit WAV is unsigned
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:                     # downmix multi-channel
        data = data.mean(axis=1)
    return data, int(sr)


def _streaming_wav_header(fs):
    """RIFF/WAVE header with unknown-length placeholder sizes (0xFFFFFFFF),
    the convention for a live-stream WAV (read until the connection
    closes)."""
    import struct

    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, int(fs), int(fs) * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def _iter_body(handler, chunk_bytes=1 << 15):
    """Request-body byte chunks: chunked transfer-encoding framing when
    present (BaseHTTPRequestHandler does not decode it), else
    Content-Length slices."""
    if handler.headers.get("Transfer-Encoding", "").lower() == "chunked":
        while True:
            size_line = handler.rfile.readline(64).strip()
            size = int(size_line.split(b";")[0], 16)
            if size == 0:
                handler.rfile.readline(8)          # trailing CRLF
                return
            remaining = size
            while remaining:
                piece = handler.rfile.read(min(remaining, chunk_bytes))
                if not piece:
                    raise ConnectionError("truncated chunked body")
                remaining -= len(piece)
                yield piece
            handler.rfile.readline(8)              # chunk CRLF
    else:
        length = int(handler.headers.get("Content-Length", 0))
        while length > 0:
            piece = handler.rfile.read(min(length, chunk_bytes))
            if not piece:
                raise ConnectionError("truncated body")
            length -= len(piece)
            yield piece


def make_handler(engine):
    """A request-handler class bound to ``engine``."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.info("%s %s", self.address_string(), fmt % args)

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _error(self, code, msg):
            self._json(code, {"error": msg})

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/health":
                self._json(200, {"status": "ok",
                                 "iteration": engine.iteration,
                                 "vocoder": engine.vocoder})
            elif path == "/speakers":
                self._json(200, engine.speakers())
            elif path == "/stats":
                self._json(200, engine.stats_snapshot())
            elif path == "/metrics":
                s = engine.stats_snapshot()
                lines = []
                for key, mtype in (("requests", "counter"),
                                   ("infer_calls", "counter"),
                                   ("infer_items", "counter"),
                                   ("mean_batch", "gauge"),
                                   ("latency_ms_p50", "gauge"),
                                   ("latency_ms_p99", "gauge"),
                                   ("queue_wait_ms_p50", "gauge"),
                                   ("queue_wait_ms_p99", "gauge")):
                    v = s.get(key)
                    if v is None:
                        continue
                    lines.append(f"# TYPE vae_npvc_{key} {mtype}")
                    lines.append(f"vae_npvc_{key} {_prom_num(v)}")
                lines += engine.latency.prometheus("vae_npvc_latency_ms")
                lines += engine.batcher.queue_wait.prometheus(
                    "vae_npvc_queue_wait_ms")
                self._send(200, ("\n".join(lines) + "\n").encode(),
                           "text/plain; version=0.0.4")
            else:
                self._error(404, f"no route {path}")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/stream":
                return self._do_stream(url)
            if url.path != "/convert":
                return self._error(404, f"no route {url.path}")
            q = parse_qs(url.query)
            target = q.get("target", [None])[0]
            if target is None:
                return self._error(400, "missing ?target=")
            want_mel = q.get("mel", ["0"])[0] not in ("0", "", "false")
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                return self._error(400, "empty body (expected WAV)")
            body = self.rfile.read(length)
            t0 = time.monotonic()
            try:
                wav, sr = _read_wav_bytes(body)
                out, fs = engine.convert(wav, sr, target,
                                         return_mel=want_mel)
            except KeyError as e:
                return self._error(400, str(e))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                logger.exception("convert failed")
                return self._error(500, f"{type(e).__name__}: {e}")
            logger.info("convert target=%s in=%.2fs out=%s %.0fms", target,
                        len(wav) / max(sr, 1), out.shape,
                        (time.monotonic() - t0) * 1e3)
            if want_mel:
                buf = io.BytesIO()
                np.save(buf, out.astype(np.float32))
                self._send(200, buf.getvalue(), "application/octet-stream")
            else:
                self._send(200, _wav_bytes(out, fs), "audio/wav")

        def _write_chunk(self, data):
            if data:
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

        def _stream_error(self, code, msg):
            # an error may leave request-body bytes unread: a reused
            # connection would read the leftover PCM as the next request,
            # so close it after the reply
            self.close_connection = True
            return self._error(code, msg)

        def _do_stream(self, url):
            from ..serve.streaming import StreamingSession

            q = parse_qs(url.query)
            target = q.get("target", [None])[0]
            sr = q.get("sr", [None])[0]
            fmt = q.get("format", ["i16"])[0]
            try:
                sr = int(sr) if sr is not None else None
            except ValueError:
                sr = None
            if target is None or sr is None:
                return self._stream_error(400, "need ?target= and "
                                               "integer ?sr=")
            if fmt not in ("i16", "f32"):
                return self._stream_error(400, f"unknown format {fmt!r}")
            # ?chunk=C[&lookahead=L]: approximate chunked conversion
            # (GroupNorm statistics over prefix + L frames); default exact
            try:
                chunk = int(q.get("chunk", [0])[0]) or None
                lookahead = int(q.get("lookahead", [64])[0])
            except ValueError:
                return self._stream_error(400, "integer ?chunk=/?lookahead=")
            dtype, width, scale = (
                (np.int16, 2, 1 / 32768.0) if fmt == "i16"
                else (np.float32, 4, 1.0))
            try:
                session = StreamingSession(engine, target, sr,
                                           chunk_frames=chunk,
                                           lookahead_frames=lookahead)
            except (KeyError, ValueError) as e:
                return self._stream_error(400, str(e))
            t0 = time.monotonic()
            try:
                carry = b""                # chunk edges can split a sample
                for piece in _iter_body(self):
                    buf = carry + piece
                    cut = len(buf) - len(buf) % width
                    carry = buf[cut:]
                    if cut:
                        session.feed(np.frombuffer(buf[:cut], dtype)
                                     .astype(np.float32) * scale)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                logger.exception("stream ingest failed")
                return self._stream_error(400, f"{type(e).__name__}: {e}")
            if engine.vocoder == "none":
                # mel-only engine: the /convert?mel=1 answer (.npy bytes)
                try:
                    (_at, mel), = session.finish()
                except Exception as e:  # noqa: BLE001
                    logger.exception("stream convert failed")
                    return self._error(500, f"{type(e).__name__}: {e}")
                buf = io.BytesIO()
                np.save(buf, mel.astype(np.float32))
                return self._send(200, buf.getvalue(),
                                  "application/octet-stream")
            # chunked response: audio leaves as synthesized; past the status
            # line a failure can only abort the connection
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                self._write_chunk(_streaming_wav_header(engine.fs))
                n_out = 0
                for _at, wav in session.finish():
                    pcm = np.clip(wav, -1.0, 1.0)
                    self._write_chunk((pcm * 32767.0).astype("<i2")
                                      .tobytes())
                    n_out += wav.size
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # noqa: BLE001 — mid-stream: abort
                logger.exception("stream emit failed")
                self.close_connection = True
                return
            logger.info("stream target=%s out=%.2fs %.0fms", target,
                        n_out / engine.fs, (time.monotonic() - t0) * 1e3)

    return Handler


def serve(engine, host="0.0.0.0", port=8080):
    """Build the HTTP server (call ``serve_forever`` on it). Handler threads
    are non-daemon so ``server_close()`` joins in-flight requests."""
    httpd = ThreadingHTTPServer((host, port), make_handler(engine))
    httpd.daemon_threads = False
    return httpd


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Online voice-conversion HTTP server (PyTorch, GPU)")
    p.add_argument("--config", default=None, help="experiment YAML")
    p.add_argument("--checkpoint", default=None,
                   help="msgpack checkpoint written by the JAX trainer")
    p.add_argument("--bundle", default=None,
                   help="exported serving-bundle dir (bin/export_serving; "
                        "replaces --config + --checkpoint)")
    p.add_argument("--cmvn", required=True,
                   help="training-time CMVN stats ark")
    p.add_argument("--spk2spk_id", default=None)
    p.add_argument("--vocoder", default="gl",
                   choices=("gl", "jpwg", "none"),
                   help="gl: Griffin-Lim; jpwg: the native Parallel "
                        "WaveGAN (--voc_config, --voc_checkpoint); none: "
                        "mel only")
    p.add_argument("--voc_config", default=None,
                   help="jpwg vocoder config (train_jpwg.yaml or .json)")
    p.add_argument("--voc_checkpoint", default=None,
                   help="jpwg vocoder checkpoint (bin/train_pwg's "
                        "model.final, JAX's or the port's)")
    p.add_argument("--gl_iters", type=int, default=64)
    p.add_argument("--feature", default=None,
                   help="YAML with fs/n_fft/n_shift/n_mels/fmin/fmax "
                        "overrides (default: vcc20 recipe values)")
    p.add_argument("--bucket_frames", type=int, default=None)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    p.add_argument("--data_parallel", action="store_true",
                   help="one model replica on every visible card; each "
                        "batch padded to a multiple of the card count and "
                        "split over them (not with --bundle)")
    p.add_argument("--warmup_buckets", type=int, default=2,
                   help="bucket shapes to run before listening")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from ..serve import ConversionEngine

    feature = None
    if args.feature:
        import yaml

        with open(args.feature) as f:
            feature = yaml.safe_load(f)
    if args.bundle is None and (args.config is None
                                or args.checkpoint is None):
        p.error("pass --config + --checkpoint, or --bundle")
    engine = ConversionEngine(
        args.config, args.checkpoint, args.cmvn, bundle=args.bundle,
        feature=feature, spk2spk_id=args.spk2spk_id, vocoder=args.vocoder,
        gl_iters=args.gl_iters, bucket_frames=args.bucket_frames,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        data_parallel=args.data_parallel, voc_config=args.voc_config,
        voc_checkpoint=args.voc_checkpoint, device=args.device)
    if args.warmup_buckets:
        engine.warmup(args.warmup_buckets)
    httpd = serve(engine, args.host, args.port)
    logger.info("listening on %s:%d (targets: %s)", args.host, args.port,
                sorted(engine.speakers()))
    import signal
    import threading

    def _term(signum, frame):
        logger.info("signal %d: shutting down", signum)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
    logger.info("shutdown complete (%d requests served)",
                engine.stats_snapshot()["requests"])


if __name__ == "__main__":
    main()

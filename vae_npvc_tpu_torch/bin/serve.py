"""Online voice-conversion HTTP server over the port's ConversionEngine.

Counterpart of ``vae_npvc_tpu/bin/serve.py``: a threaded stdlib HTTP server
whose handler threads submit work to the engine; the engine's batcher
thread owns the GPU.

Endpoints
---------
``GET  /health``                     liveness + checkpoint iteration
``GET  /speakers``                   target-name -> id map
``GET  /stats``                      request/batching/latency counters
``GET  /metrics``                    the same, Prometheus text format
``POST /convert?target=NAME``        body = WAV file -> converted WAV
``POST /convert?target=NAME&mel=1``  -> float32 mel matrix (``.npy`` bytes)

(``/stream`` belongs to a later slice.) Example::

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
                                   ("latency_ms_p99", "gauge")):
                    v = s.get(key)
                    if v is None:
                        continue
                    lines.append(f"# TYPE vae_npvc_{key} {mtype}")
                    lines.append(f"vae_npvc_{key} {_prom_num(v)}")
                self._send(200, ("\n".join(lines) + "\n").encode(),
                           "text/plain; version=0.0.4")
            else:
                self._error(404, f"no route {path}")

        def do_POST(self):
            url = urlparse(self.path)
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
                   help="not ported yet")
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

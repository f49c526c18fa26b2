"""Batched HTTP inference server (``tpu_unet/serve.py``): by default on the
unfolded eval-mode forward (``unet_apply(train=False)``), as the reference
serves without ``--kernels``; with ``--kernels cuda|torch`` on the folded-BN
forward (``unet_infer_apply``). ``--tta`` serves the flip ensemble, its views
as batch rows of the canvas; ``--tile N`` runs a group whose preprocessed
shape holds one window (tile + 2·halo, after padding to 16) through the
tiled sweep (``parallel/tiling.py``), other groups through the full-image
forward. ``--device-preprocess`` (on by default with ``--tile``, as in the
JAX package) decodes on the host and resizes and normalises on the device
(``data/device_pipeline.py``), bitwise the host preprocess; requests of
another mode than L or RGB take the host path.

The model stays resident on the device. Requests that arrive within
``batch_window_ms`` of each other are grouped by preprocessed shape; each
group runs as one batch on a zero-padded canvas whose batch size is the next
power of two (at most ``max_batch``), so every mask equals a solo prediction.

Endpoints:
  POST /predict   body: PNG/JPEG bytes -> PNG mask at the image's resolution
  GET  /healthz   liveness and model metadata JSON
  GET  /metrics   request and error counts, end-to-end latency p50/p90/p99
                  over a sliding window, dispatches and their mean batch

Run: ``python -m tpu_unet_torch.serve -m ckpt.npz|model.pth --port 8000
[--kernels cuda|torch | --tile 512 [--halo 128]] [--tta [--tta-mode hflip]]
[--[no-]device-preprocess]``
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import signal
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
from PIL import Image

from tpu_unet_torch.data.device_pipeline import raw_u8_for_device
from tpu_unet_torch.data.loading import preprocess
from tpu_unet_torch.models import UNetConfig, fold_bn, unet_infer_apply
from tpu_unet_torch.models.infer import BACKENDS
from tpu_unet_torch.models.tta import TTA_MODES, tta_merge, tta_views
from tpu_unet_torch.models.unet import tree_map, unet_apply
from tpu_unet_torch.ops import resize_bilinear
from tpu_unet_torch.parallel.tiling import (
    DEFAULT_HALO,
    min_halo,
    padded_hw,
    tiled_forward_padded,
)
from tpu_unet_torch.predict import (
    _device_resized,
    load_model,
    logits_to_mask,
    mask_to_image,
    refuse_unported,
    resolve_device,
)

logger = logging.getLogger(__name__)


class ServeMetrics:
    """Sliding-window serving metrics (thread-safe). Latency is end to end
    per request: enqueue -> mask ready (queue wait, preprocess, forward,
    logit upscale, threshold)."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._lat: deque[float] = deque(maxlen=window)
        self._batch: deque[int] = deque(maxlen=window)
        self.requests = 0
        self.errors = 0
        self.started = time.time()

    def record(self, latency_s: float):
        with self._lock:
            self.requests += 1
            self._lat.append(latency_s)

    def record_error(self, n: int = 1):
        with self._lock:
            self.requests += n
            self.errors += n

    def record_dispatch(self, batch_size: int):
        with self._lock:
            self._batch.append(batch_size)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            batches = list(self._batch)
            out = {"requests": self.requests, "errors": self.errors,
                   "uptime_s": round(time.time() - self.started, 1), "window": len(lat)}
        if lat:
            # Nearest-rank quantile: ceil(p * n) - 1.
            def q(p):
                return round(lat[max(0, -(-int(p * 100) * len(lat) // 100) - 1)] * 1e3, 2)

            out["latency_ms"] = {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99)}
        if batches:
            out["dispatches"] = len(batches)
            out["dispatch_batch_mean"] = round(sum(batches) / len(batches), 2)
        return out


class BatchedPredictor:
    """Model resident on ``device`` + micro-batching queue: the eval-mode
    forward when ``kernels`` is None (with ``tta``, the flip ensemble; with
    ``tile``, the tiled sweep for groups large enough), else the folded-BN
    forward on that backend. ``device_preprocess`` (None: on iff ``tile``)
    sends L and RGB requests to the device raw, resized there before
    whichever forward runs. Thread-safe ``predict_one`` entry; ``stop`` ends
    the worker threads."""

    def __init__(self, params, state, config: UNetConfig, mask_values, *,
                 device: str | torch.device = "cuda", kernels: str | None = None,
                 scale: float = 0.5, threshold: float = 0.5, amp: bool = True,
                 max_batch: int = 8, batch_window_ms: float = 5.0,
                 timeout_s: float = 300.0, tile: int | None = None,
                 halo: int = DEFAULT_HALO, tta: bool = False, tta_mode: str = "flips",
                 device_preprocess: bool | None = None):
        if kernels is not None and kernels not in BACKENDS:
            raise ValueError(f"kernels must be None or one of {BACKENDS}, got {kernels!r}")
        if tile is not None and (tile % 16 or halo % 16):
            # Window starts must stay 16-aligned for exact stitching: refuse
            # at startup, not with a 500 on every large request.
            raise ValueError(f"--tile/--halo must be multiples of 16 "
                             f"(got tile={tile}, halo={halo})")
        if tile and kernels:
            raise ValueError("--tile serving runs the eval forward (not --kernels)")
        if tta and kernels:
            raise ValueError("--tta serving composes with the eval forward (default or "
                             "--tile), not --kernels")
        if tile and halo < min_halo(config):
            logger.warning("serve --tile: halo %d below arch=%r requirement — using halo=%d",
                           halo, config.arch, min_halo(config))
            halo = min_halo(config)
        self.tile, self.halo = tile, halo
        self.tta, self.tta_mode = tta, tta_mode
        # The JAX package's default: tiled serving (large images, where the
        # host resize dominates a request) preprocesses on the device.
        self.device_preprocess = bool(tile) if device_preprocess is None else device_preprocess
        if tile and not self.device_preprocess:
            logger.info("serve --tile with --no-device-preprocess: device preprocess (the "
                        "same masks) is the default for tiled serving")
        self._dp_warned_modes: set[str] = set()
        self.device = resolve_device(device)
        self.config = config
        self.kernels = kernels
        self.mask_values = mask_values or (
            [0, 1] if config.n_classes == 1 else list(range(config.n_classes)))
        self.scale = scale
        self.threshold = threshold
        self.amp = amp
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1e3
        self.timeout_s = timeout_s
        self.metrics = ServeMetrics()
        self._compute_dtype = torch.bfloat16 if amp else None
        # Keep the weights on the device in the compute dtype, so a forward
        # casts nothing: folded once for the kernels; the eval forward's BN
        # state stays fp32, as unet_apply takes it.
        dtype = self._compute_dtype or torch.float32
        if kernels is None:
            self._params = tree_map(lambda t: t.to(self.device, dtype), params)
            self._state = tree_map(lambda t: t.to(self.device), state)
        else:
            self._folded = tree_map(lambda t: t.to(self.device, dtype),
                                    fold_bn(params, state, config))
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._acct_lock = threading.Lock()
        # Shape groups run on this pool: a small group's forward and fetch do
        # not wait behind a big group's.
        self._group_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="serve-group")
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC float32 batch on the device -> fp32 logits. With ``tile``, a
        batch whose padded H and W hold one window runs the tiled sweep; with
        ``tta``, the flip views of the whole batch run as one and are merged
        with ``n`` the batch size."""
        if self.kernels is not None:
            return unet_infer_apply(self._folded, x, config=self.config, backend=self.kernels,
                                    compute_dtype=self._compute_dtype)
        views = tta_views(x, self.tta_mode) if self.tta else x
        if self.tile and self.tile + 2 * self.halo <= min(padded_hw(x.shape[1], x.shape[2])):
            logits = tiled_forward_padded(self._params, self._state, views, config=self.config,
                                          tile=self.tile, halo=self.halo, amp=self.amp)
        else:
            logits = unet_apply(self._params, self._state, views, config=self.config,
                                train=False, compute_dtype=self._compute_dtype)[0]
        return tta_merge(logits, x.shape[0], self.tta_mode) if self.tta else logits

    # -- client side ------------------------------------------------------
    def predict_one(self, img: Image.Image, timeout: float | None = None) -> np.ndarray:
        """Blocking: enqueue one image, receive its full-resolution mask."""
        done = threading.Event()
        slot: dict = {}
        self._queue.put((img, slot, done, time.monotonic()))
        if not done.wait(self.timeout_s if timeout is None else timeout):
            # Claim the request's accounting so a late completion by the
            # worker does not count it again.
            if self._claim(slot):
                self.metrics.record_error()
            raise TimeoutError("prediction timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["mask"]

    def _claim(self, slot: dict) -> bool:
        """The first caller (worker completion or timed-out waiter) owns the
        request's metrics accounting."""
        with self._acct_lock:
            if slot.get("accounted"):
                return False
            slot["accounted"] = True
            return True

    # -- server side ------------------------------------------------------
    def _preprocess(self, img: Image.Image) -> np.ndarray:
        """The host's part of one request: with ``device_preprocess``, the
        decoded uint8 HWC array of an L or RGB image (the device resizes
        it); else, or for other modes, the preprocessed float32 array."""
        if self.device_preprocess:
            arr = raw_u8_for_device(img)
            if arr is not None:
                if int(self.scale * arr.shape[0]) <= 0 or int(self.scale * arr.shape[1]) <= 0:
                    raise ValueError("Scale is too small, resized images would have no pixel")
                return arr
            mode = getattr(img, "mode", "?")
            if mode not in self._dp_warned_modes:  # once per mode, not per request
                self._dp_warned_modes.add(mode)
                logger.warning("request image not device-preprocessable (mode %s): host "
                               "preprocess for such requests", mode)
        return preprocess(img, self.scale)

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.batch_window
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run_batch(batch)

    def _run_batch(self, batch):
        # Preprocess per request: one bad image fails only its own waiter.
        pre = {}
        for k, (img, slot, done, _) in enumerate(batch):
            try:
                pre[k] = self._preprocess(img)
            except Exception as e:  # noqa: BLE001 - reported to the request's waiter
                logger.exception("preprocess failed")
                if self._claim(slot):
                    self.metrics.record_error()
                slot["error"] = str(e)
                done.set()
        # One canvas per (H, W, C, dtype): zero-padding a smaller image onto
        # a larger canvas would shift its pool/upsample grid and change its
        # mask, and a raw uint8 request must not share a canvas with a
        # host-preprocessed one of the same shape.
        groups: dict[tuple, list[int]] = {}
        for k, arr in pre.items():
            groups.setdefault(arr.shape + (arr.dtype.str,), []).append(k)
        for key, idxs in sorted(groups.items(), key=lambda kv: kv[0][0] * kv[0][1]):
            self._group_pool.submit(self._run_group, key, idxs, pre, batch)

    def _run_group(self, key, idxs, pre, batch):
        try:
            self.metrics.record_dispatch(len(idxs))
            # Canvas batch = next power of two >= group size.
            bsz = min(self.max_batch, 1 << max(0, len(idxs) - 1).bit_length())
            canvas = np.zeros((bsz, *key[:-1]), pre[idxs[0]].dtype)
            for j, k in enumerate(idxs):
                canvas[j] = pre[k]
            with torch.inference_mode():
                x = torch.from_numpy(canvas).to(self.device)
                if x.dtype == torch.uint8:
                    # Raw canvas: resized on the device before the forward. The
                    # all-zero pad rows stay zero (max <= 1: no /255).
                    x = _device_resized(x, self.scale)
                logits = self.forward(x)
                for j, k in enumerate(idxs):
                    img, slot, done, t_enq = batch[k]
                    full_w, full_h = img.size
                    lg = resize_bilinear(logits[j:j + 1], full_h, full_w, align_corners=False)
                    slot["mask"] = logits_to_mask(lg[0], self.config.n_classes, self.threshold)
                    if self._claim(slot):  # skip requests whose waiter timed out
                        self.metrics.record(time.monotonic() - t_enq)
                    done.set()
        except Exception as e:  # noqa: BLE001 - every waiter of the group must hear of it
            logger.exception("group %s failed", key)
            # Only requests still in flight: a finished one keeps its mask.
            pending = [k for k in idxs if not batch[k][2].is_set()]
            self.metrics.record_error(sum(self._claim(batch[k][1]) for k in pending))
            for k in pending:
                _, slot, done, _ = batch[k]
                slot["error"] = str(e)
                done.set()

    def warmup(self, height: int, width: int) -> float:
        """Push one blank image of this raw size through the whole path;
        return the seconds it took."""
        t0 = time.monotonic()
        self.predict_one(Image.new("RGB", (width, height)))
        dt = time.monotonic() - t0
        logger.info("Warmup %dx%d done in %.1f s", height, width, dt)
        return dt

    def stop(self):
        self._stop.set()
        self._worker.join(timeout=2)
        self._group_pool.shutdown(wait=True)


def make_handler(predictor: BatchedPredictor, max_body_bytes: int = 64 << 20):
    """HTTP handler over one predictor. Bodies over ``max_body_bytes`` get
    413 before any read."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _json(self, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json({"status": "ok", "n_classes": predictor.config.n_classes,
                            "arch": predictor.config.arch, "scale": predictor.scale,
                            "kernels": predictor.kernels, "device": str(predictor.device),
                            "amp": predictor.amp, "tta": predictor.tta,
                            "tile": predictor.tile,
                            "device_preprocess": predictor.device_preprocess})
            elif self.path == "/metrics":
                self._json(predictor.metrics.snapshot())
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                predictor.metrics.record_error()
                self.send_error(400, "invalid Content-Length")
                return
            if length > max_body_bytes:
                self.send_error(413, f"body {length} bytes exceeds cap {max_body_bytes}")
                return
            try:
                try:
                    img = Image.open(io.BytesIO(self.rfile.read(length)))
                except Exception:
                    # Decode failures never reach the batch loop: count here.
                    predictor.metrics.record_error()
                    raise
                mask = predictor.predict_one(img)
                out = io.BytesIO()
                mask_to_image(mask, predictor.mask_values).save(out, format="PNG")
                data = out.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:  # noqa: BLE001 - the client gets a 500 with the reason
                self.send_error(500, str(e)[:200])

    return Handler


def build_predictor(model_path: str, args) -> BatchedPredictor:
    """A predictor for a ``.npz`` checkpoint or a ``.pth`` state dict, warmed
    up when asked."""
    device = resolve_device(args.device)
    config = UNetConfig(3, args.classes, bilinear=args.bilinear)
    params, state, config, mask_values = load_model(model_path, config, device)
    predictor = BatchedPredictor(
        params, state, config, mask_values,
        device=device, kernels=args.kernels, scale=args.scale, threshold=args.mask_threshold,
        amp=args.amp, max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        timeout_s=args.timeout_s, tile=args.tile, halo=args.halo, tta=args.tta,
        tta_mode=args.tta_mode, device_preprocess=args.device_preprocess)
    if args.warmup:
        h, w = (int(v) for v in args.warmup.lower().split("x"))
        predictor.warmup(h, w)
        predictor.metrics = ServeMetrics()  # warmup must not skew the percentiles
    return predictor


def get_args(argv=None):
    p = argparse.ArgumentParser(description="tpu-unet batched inference server (PyTorch port)")
    p.add_argument("--model", "-m", required=True,
                   help="The model to serve: a .npz checkpoint or a torch .pth state dict")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--scale", "-s", type=float, default=0.5)
    p.add_argument("--mask-threshold", "-t", type=float, default=0.5)
    p.add_argument("--classes", "-c", type=int, default=1)
    p.add_argument("--bilinear", action="store_true")
    p.add_argument("--amp", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 inference (default on; --no-amp for fp32)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--kernels", choices=BACKENDS, default=None,
                   help="the folded-BN forward on cuda: the hand-written kernels, or torch: "
                        "their plain versions; without it, the unfolded eval-mode forward")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    p.add_argument("--timeout-s", type=float, default=300.0, help="Per-request wait bound")
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="Reject POST bodies larger than this with 413")
    p.add_argument("--warmup", type=str, default=None, metavar="HxW",
                   help="Run one blank request of this raw size before serving")
    p.add_argument("--tta", action="store_true", default=False,
                   help="Flip-ensemble TTA: the views ride as batch rows of each group")
    p.add_argument("--tta-mode", choices=tuple(TTA_MODES), default="flips",
                   help="TTA views: all four flips, or identity + left-right only")
    p.add_argument("--tile", type=int, default=None,
                   help="Serve large images through the tiled sweep (activations of "
                        "4 windows, not the image); per request group, when its "
                        "preprocessed shape holds one window, else full-image")
    p.add_argument("--halo", type=int, default=DEFAULT_HALO,
                   help="Tile overlap; must cover the receptive field (110 px)")
    p.add_argument("--device-preprocess", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Resize and normalise each request on the device (Pillow-bit-exact "
                        "int32 resample, the same masks); the host keeps only the decode. "
                        "Default: on with --tile, off otherwise")
    return p.parse_args(argv)


def make_server(argv=None) -> tuple[ThreadingHTTPServer, BatchedPredictor]:
    """Parse the CLI, load the model and bind the server (not yet serving).
    ``--port 0`` binds a free port: read it from ``server.server_address``."""
    args = get_args(argv)
    refuse_unported(args, "tpu_unet_torch.serve", ())
    predictor = build_predictor(args.model, args)
    handler = make_handler(predictor, max_body_bytes=args.max_body_mb << 20)
    server = ThreadingHTTPServer((args.host, args.port), handler)
    logger.info("Serving %s on %s:%d (kernels=%s, tile=%s, tta=%s, device_preprocess=%s, "
                "device=%s, max_batch=%d)", args.model, args.host, server.server_address[1],
                args.kernels, args.tile, args.tta, predictor.device_preprocess,
                predictor.device, args.max_batch)
    return server, predictor


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    server, predictor = make_server(argv)

    def _terminate(signum, frame):
        logger.info("SIGTERM received, shutting down")
        # shutdown() waits for serve_forever, which runs on this thread.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _terminate)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        predictor.stop()
        logger.info("Server stopped")


if __name__ == "__main__":
    main()

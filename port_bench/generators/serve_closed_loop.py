"""Traffic kind ``serve_closed_loop``: the port's serve engine
(``tpu_unet_torch.serve.BatchedPredictor``) in process, under ``clients``
client threads that each call ``predict_one`` on their next image as soon as
their mask returns (a closed loop). HTTP and the PNG decode and encode are
left out: the clients hand decoded images to the engine and take its masks.

Set-up draws ``pool_images`` synthetic Carvana images of the
configuration's ``image`` size on the device, decodes them to PIL images
on the host, draws the weights and takes the BN statistics from a train-
mode pass of the reference over two other images (a trained model's
statistics normalise its activations; init's do not), builds the engine,
warms the canvases of ``warm_canvases`` images through the engine's own
path, and then runs all clients for ``warm_seconds``.

The window times every request issued in it, from the client's call to
the mask in its hands; one that fails or times out (``request_timeout_s``)
counts as failed and as missing any latency limit. The rate counts the
masks returned within the window. Each client keeps a seeded reservoir of
``sample_per_client`` of its masks, which the reference checks after the
window.

Traffic parameters: ``amp``, ``clients``, ``max_batch``,
``batch_window_ms``, ``device_preprocess``, ``pool_images``,
``warm_canvases``, ``warm_seconds``, ``sample_per_client``,
``request_timeout_s``.
"""

from __future__ import annotations

import itertools
import math
import random
import threading
import time

import torch
from PIL import Image

from port_bench import check, inputs, reference, yardstick
from port_bench.program import model_config, trees_for


class _Client(threading.Thread):
    def __init__(self, k, order, predictor, images, gate, stop_at, ctx, keep, timeout):
        super().__init__(name=f"bench-client-{k}", daemon=True)
        self.k, self.order, self.predictor, self.images = k, order, predictor, images
        self.gate, self.stop_at, self.ctx, self.timeout = gate, stop_at, ctx, timeout
        self.records: list[tuple[float, float, bool]] = []
        self.keep, self.kept, self.rng = keep, [], random.Random(f"{ctx.seed}/{k}")
        self.error: BaseException | None = None

    def run(self):
        try:
            self.gate.wait()
            for j in itertools.count():
                t0 = time.perf_counter()
                if t0 >= self.stop_at[0]:
                    break
                idx = self.order[j % len(self.order)]
                ok, mask = True, None
                with self.ctx.spans.span("serve.predict_one"):
                    try:
                        mask = self.predictor.predict_one(self.images[idx], timeout=self.timeout)
                    except Exception:  # noqa: BLE001 - a failed request is counted, not raised
                        ok = False
                t1 = time.perf_counter()
                self.records.append((t0, t1, ok))
                if ok and self.keep:
                    n = len(self.records)
                    if len(self.kept) < self.keep:
                        self.kept.append((idx, mask))
                    elif (r := self.rng.randrange(n)) < self.keep:
                        self.kept[r] = (idx, mask)
        except BaseException as e:  # noqa: BLE001 - re-raised by the run after join
            self.error = e


def _start_clients(predictor, images, orders, ctx, keep, timeout):
    """Start one client a stream of ``orders``, each waiting at the gate;
    the caller sets ``stop_at[0]``, the host time after which no client
    sends, then passes the gate."""
    gate = threading.Barrier(len(orders) + 1)
    stop_at = [math.inf]
    clients = [_Client(k, o, predictor, images, gate, stop_at, ctx, keep, timeout)
               for k, o in enumerate(orders)]
    for c in clients:
        c.start()
    return clients, gate, stop_at


def _join(clients, timeout):
    for c in clients:
        c.join(timeout + 60)
        if c.is_alive():
            raise RuntimeError(f"{c.name} did not finish its last request")
        if c.error is not None:
            raise c.error


def _warm_canvas(predictor, b: int, h: int, w: int, device):
    """One canvas of ``b`` images through the path ``_run_group`` takes:
    device resize, the forward, each mask's logit upscale and threshold."""
    from tpu_unet_torch.predict import _device_resized, logits_to_mask
    from tpu_unet_torch.ops import resize_bilinear

    with torch.inference_mode():
        x = _device_resized(torch.zeros((b, h, w, 3), dtype=torch.uint8, device=device),
                            predictor.scale)
        logits = predictor.forward(x)
        for j in range(b):
            lg = resize_bilinear(logits[j:j + 1], h, w, align_corners=False)
            logits_to_mask(lg[0], predictor.config.n_classes, predictor.threshold)


def run(ctx) -> dict:
    from tpu_unet_torch.serve import BatchedPredictor, ServeMetrics

    class WindowMetrics(ServeMetrics):
        """The engine's metrics, keeping every dispatch's batch size."""

        def __init__(self):
            super().__init__()
            self.dispatches: list[tuple[float, int]] = []

        def record_dispatch(self, batch_size: int):
            super().record_dispatch(batch_size)
            self.dispatches.append((time.perf_counter(), batch_size))

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    H, W, scale = cfg["image"]["height"], cfg["image"]["width"], cfg["image"]["scale"]
    h, w = int(scale * H), int(scale * W)
    g = inputs.generator(ctx.seed, dev)
    weights = inputs.make_weights(cfg["model"], g, dev)
    calib, _ = inputs.carvana_images(g, 2, h, w, dev)
    with reference.precision(tf32=False):
        bn = reference.calibrated_bn_state(cfg["model"], weights, calib.float() / 255.0)
    del calib
    u8, _ = inputs.carvana_images(g, tr["pool_images"], H, W, dev)
    images = [Image.fromarray(a, "RGB") for a in u8.cpu().numpy()]
    del u8
    perm = torch.randperm(tr["clients"] * len(images), generator=g, device=dev).cpu()
    orders = [(perm[k::tr["clients"]] % len(images)).tolist() for k in range(tr["clients"])]

    mcfg = model_config(cfg)
    params, state = trees_for(mcfg, weights, bn)
    predictor = BatchedPredictor(
        params, state, mcfg, [0, 1], device=dev, kernels=ctx.kernels("serve"), scale=scale,
        threshold=0.5, amp=tr["amp"], max_batch=tr["max_batch"],
        batch_window_ms=tr["batch_window_ms"], device_preprocess=tr["device_preprocess"])
    weights_host = {k: v.cpu() for k, v in weights.items()}
    bn_host = {k: v.cpu() for k, v in bn.items()}
    del params, state, weights, bn
    timeout = tr["request_timeout_s"]
    try:
        with ctx.spans.span("setup.warm_canvases"):
            for b in tr["warm_canvases"]:
                _warm_canvas(predictor, b, H, W, dev)
        with ctx.spans.span("setup.warm_traffic"):
            clients, gate, stop_at = _start_clients(predictor, images, orders, ctx, 0, timeout)
            stop_at[0] = time.perf_counter() + tr["warm_seconds"]
            gate.wait()
            _join(clients, timeout)
        predictor.metrics = WindowMetrics()
        clients, gate, stop_at = _start_clients(predictor, images, orders, ctx,
                                                tr["sample_per_client"], timeout)
        with ctx.window() as win:
            stop_at[0] = win.t0 + ctx.seconds
            gate.wait()
            time.sleep(max(0.0, stop_at[0] - time.perf_counter()))
        with ctx.spans.span("serve.window_close"):
            _join(clients, timeout)
        dispatches = [b for t, b in predictor.metrics.dispatches if t < stop_at[0]]
    finally:
        predictor.stop()
    del predictor
    ctx.free()

    stats = yardstick.request_stats([r for c in clients for r in c.records],
                                    win.t0 + ctx.seconds, ctx.seconds, timeout * 1e3)
    sample = [kv for c in clients for kv in c.kept]
    t_ref = time.perf_counter()
    gap = _mask_gap(cfg, weights_host, bn_host, images, sample, dev, H, W, h, w)
    return {
        "attempted": stats["attempted"], "failed": stats["failed"],
        "end_to_end": {"serve_img_s": stats["rate"], "serve_p95_ms": stats["p95_ms"]},
        "numbers": {"mask_gap": gap},
        "diagnostics": {"sampled_masks": len(sample), "p50_ms": stats["p50_ms"],
                        "reference_s": time.perf_counter() - t_ref},
        "readings": {"kind": "serve", "images": stats["done"], "window_s": ctx.seconds,
                     "dispatches": dispatches, "height": h, "width": w},
    }


def _mask_gap(cfg, weights_host, bn_host, images, sample, dev, H, W, h, w, block: int = 4):
    if not sample:
        raise RuntimeError("no served mask to check")
    weights = {k: v.to(dev) for k, v in weights_host.items()}
    bn = {k: v.to(dev) for k, v in bn_host.items()}
    gap = 0.0
    for s in range(0, len(sample), block):
        part = sample[s:s + block]
        z = reference.served_logits(cfg, weights, bn, images, [i for i, _ in part], dev, H, W,
                                    h, w)
        for (_, mask), zi in zip(part, z):
            gap = max(gap, check.mask_gap(mask, zi))
    return gap

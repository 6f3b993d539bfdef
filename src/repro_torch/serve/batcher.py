"""Shape-bucketed image classification through the fused conv2d stack.

Port of ``repro.serve.batcher``'s CNN side.  :class:`CnnBatcher` queues
variable-sized images, rounds each up to an H×W *shape bucket* (host-side
zero-pad), and flushes every bucket through one classify function per
bucket, which zero-pads the bucket up to the model's native ``cfg.in_chw``
on the device.  Zero-padding is exact for the conv stack: the head sees the
same feature map as a natively-sized zero-extended image.

The JAX version jits one closure per bucket and pads every chunk to
``max_batch`` images to keep its shape static; PyTorch runs eagerly, so a
chunk runs at its own size.  :class:`MixedBatcher` interleaves one LM
:class:`~repro_torch.serve.engine.Engine` tick with a CNN flush per service
tick, so both traffic classes share the process continuously.

Metrics ride :class:`repro_torch.serve.metrics.Metrics` (img/s, p50/p99
latency) under ``"cnn-<n>"`` uids.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch._device import resolve_device
from repro_torch.serve.metrics import Metrics

__all__ = ["CnnRequest", "CnnBatcher", "MixedBatcher", "default_hw_buckets"]


def default_hw_buckets(native_hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Power-of-two-ish H×W ladder up to (and including) the native size."""
    H, W = native_hw
    ladder = []
    h = 8
    while h < max(H, W):
        ladder.append((min(h, H), min(h, W)))
        h *= 2
    ladder.append((H, W))
    return sorted(set(ladder))


@dataclasses.dataclass
class CnnRequest:
    uid: str
    image: np.ndarray  # (C, H, W) float32
    bucket: Tuple[int, int]
    cls: Optional[int] = None
    logits: Optional[np.ndarray] = None  # (classes,) float32, once served
    done: bool = False
    stuck: bool = False


class CnnBatcher:
    """Shape-bucketed image classification through the fused conv2d stack.

    ``params`` must already live on ``device`` (default the card; raises
    when CUDA is absent — pass ``device="cpu"`` for the plain path).
    ``n_batches`` counts the forward passes run so far.
    """

    def __init__(
        self,
        cfg,  # CNNConfig
        params,
        *,
        max_batch: int = 8,
        buckets: Optional[List[Tuple[int, int]]] = None,
        metrics: Optional[Metrics] = None,
        clock: Callable[[], float] = time.perf_counter,
        device=None,
    ):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.device = resolve_device(device)
        C, H, W = cfg.in_chw
        self.native_hw = (H, W)
        self.buckets = sorted(buckets or default_hw_buckets((H, W)))
        self.metrics = metrics if metrics is not None else Metrics(clock=clock)
        self.waiting: deque[CnnRequest] = deque()
        self.n_batches = 0
        self._n = 0
        self._classify: Dict[Tuple[int, int], Callable] = {}

    def _bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        for bh, bw in self.buckets:
            if h <= bh and w <= bw:
                return (bh, bw)
        raise ValueError(
            f"image {h}x{w} exceeds native input {self.native_hw} "
            f"(buckets: {self.buckets})"
        )

    def _classify_fn(self, bucket: Tuple[int, int]) -> Callable:
        if bucket not in self._classify:
            from repro_torch.models import cnn as _cnn

            cfg, (bh, bw) = self.cfg, bucket
            H, W = self.native_hw

            def f(params, images):  # (n, C, bh, bw) → (n, classes)
                x = F.pad(images, (0, W - bw, 0, H - bh))
                if cfg.layout == "NHWC":
                    x = x.permute(0, 2, 3, 1).contiguous()
                return _cnn.forward(params, x, cfg)

            self._classify[bucket] = f
        return self._classify[bucket]

    # -- request lifecycle ---------------------------------------------------

    def submit(self, image: np.ndarray, *, slo_s: Optional[float] = None) -> CnnRequest:
        image = np.asarray(image, np.float32)
        if image.ndim != 3 or image.shape[0] != self.cfg.in_chw[0]:
            raise ValueError(
                f"expected (C={self.cfg.in_chw[0]}, H, W), got {image.shape}")
        self._n += 1
        r = CnnRequest(uid=f"cnn-{self._n}", image=image,
                       bucket=self._bucket_for(image.shape[1], image.shape[2]))
        self.waiting.append(r)
        self.metrics.submit(r.uid, "cnn", slo_s=slo_s)
        return r

    @torch.no_grad()
    def flush(self) -> List[CnnRequest]:
        """Serve every waiting image: group by bucket, pad, classify."""
        by_bucket: Dict[Tuple[int, int], List[CnnRequest]] = {}
        while self.waiting:
            r = self.waiting.popleft()
            by_bucket.setdefault(r.bucket, []).append(r)
        served: List[CnnRequest] = []
        C = self.cfg.in_chw[0]
        for bucket, reqs in by_bucket.items():
            bh, bw = bucket
            for i in range(0, len(reqs), self.max_batch):
                chunk = reqs[i : i + self.max_batch]
                with trace.span("batcher.stage", n=len(chunk)):
                    imgs = np.zeros((len(chunk), C, bh, bw), np.float32)
                    for j, r in enumerate(chunk):
                        h, w = r.image.shape[1:]
                        imgs[j, :, :h, :w] = r.image
                        self.metrics.mark_admit(r.uid)
                with trace.span("batcher.h2d", device=self.device.type == "cuda",
                                n=len(chunk)):
                    x = torch.from_numpy(imgs).to(self.device)
                logits = self._classify_fn(bucket)(self.params, x)
                self.n_batches += 1
                cls = torch.argmax(logits, dim=-1).cpu().numpy()
                logits = logits.cpu().numpy()
                for j, r in enumerate(chunk):
                    r.cls = int(cls[j])
                    r.logits = logits[j]
                    r.done = True
                    self.metrics.mark_first(r.uid)
                    self.metrics.mark_done(r.uid, 1)
                served.extend(chunk)
        return served


class MixedBatcher:
    """One service loop over both traffic classes: every tick runs one LM
    engine step (continuous admit + batched decode) and one CNN flush."""

    def __init__(self, engine, cnn: Optional[CnnBatcher] = None):
        self.engine = engine
        self.cnn = cnn

    @property
    def drained(self) -> bool:
        # engine.busy covers live slots, the queue AND pending retries: a
        # backoff-delayed retry keeps the loop ticking until it resolves
        lm_done = not self.engine.busy
        cnn_done = self.cnn is None or not self.cnn.waiting
        return lm_done and cnn_done

    def tick(self):
        self.engine.step()
        if self.cnn is not None:
            self.cnn.flush()

    def run_until_drained(self, max_ticks: int = 1000, *, strict: bool = True) -> int:
        t = 0
        while not self.drained and t < max_ticks:
            self.tick()
            t += 1
        if not self.drained:
            msg = f"MixedBatcher: traffic undrained after {max_ticks} ticks"
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return t

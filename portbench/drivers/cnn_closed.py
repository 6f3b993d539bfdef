"""Image classification in a closed loop through ``CnnBatcher``.

``clients`` clients each send one image and send their next when its answer
comes.  Each round the harness flushes the batcher, which serves every
waiting image in chunks of ``max_batch``, and the answered clients send
again.  Images come from a pool of ``pool`` drawn from the seed at set-up,
in an order drawn from the seed.  Every answer served in the window is
held against the reference's logits for its image.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import traffic
from portbench.reference import cnn as ref_cnn
from portbench.reference import draw

__all__ = ["port_config", "port_params", "setup", "window", "free", "check"]


def port_config(cfg: dict):
    """The configuration file as the port's ``CNNConfig``."""
    from repro_torch.configs.alexnet_conv import CNNConfig
    from repro_torch.core.conv import Conv2D

    layers, c_in = [], cfg["in_chw"][0]
    for c_out, k, stride in cfg["layers"]:
        layers.append(Conv2D(k=k, c_in=c_in, c_out=c_out, stride=stride, relu=True))
        c_in = c_out
    return CNNConfig(name=cfg["name"], in_chw=tuple(cfg["in_chw"]), layers=tuple(layers),
                     pools=tuple(cfg["pools"]), classes=cfg["classes"], bins=cfg["bins"],
                     impl=cfg["impl"], padding=cfg["padding"], layout=cfg["layout"])


def port_params(cfg: dict, seed: int, device) -> dict:
    """The drawn weights in the port's containers (``ConvParams.shared``)."""
    from repro_torch.core.conv import ConvParams

    convs, c_in = [], cfg["in_chw"][0]
    for i, (c_out, k, _stride) in enumerate(cfg["layers"]):
        idx, cb, b = draw.cnn_conv(seed, i, c_out, c_in, k, cfg["bins"], device)
        convs.append(ConvParams.shared(idx, cb, bias=b))
        c_in = c_out
    w, b = draw.cnn_head(seed, cfg["features"], cfg["classes"], device)
    return {"conv": convs, "head": {"w": w, "b": b}}


def _batcher(run, pcfg, params):
    from repro_torch.serve.batcher import CnnBatcher

    spans = run.spans

    class Batcher(CnnBatcher):
        def _classify_fn(self, bucket):
            f = super()._classify_fn(bucket)

            def classify(params, images):
                with spans.span("classify", sync=True, n=int(images.shape[0])):
                    return f(params, images)

            return classify

    return Batcher(pcfg, params, max_batch=run.mix["max_batch"], device=run.device)


def setup(run) -> None:
    if run.cuda:
        from repro_torch.kernels import _build

        _build.build()
    cfg, mix = run.cfg, run.mix
    pcfg = port_config(cfg)
    params = port_params(cfg, run.seed, run.device)
    pool = draw.images(run.seed, mix["pool"], cfg["in_chw"])
    b = _batcher(run, pcfg, params)
    for i in range(mix["clients"]):  # the warm-up: the window's own rounds
        b.submit(pool[i % len(pool)])
    for _ in range(2):
        for r in b.flush():
            b.submit(r.image)
    b.waiting.clear()
    run.state.update(batcher=b, params=params, pool=pool)


def window(run) -> None:
    st, mix = run.state, run.mix
    b, pool = st["batcher"], st["pool"]
    order = traffic.image_order(run.seed, len(pool), 1 << 22)
    sent = {}  # request uid -> pool index
    answers = []  # (pool index, logits) of every answer in the window

    def send():
        i = int(order[len(sent)])
        r = b.submit(pool[i])
        sent[r.uid] = i

    for _ in range(mix["clients"]):
        send()
    n_batches0 = b.n_batches
    clock = time.perf_counter
    run.start_window()
    while True:
        with run.spans.span("flush"):
            done = b.flush()
        now = clock()
        answers.extend((sent[r.uid], r.logits) for r in done)
        if now >= run.t0 + run.seconds:
            break
        run.profile_tick(now)
        with run.spans.span("submit"):
            for _ in done:
                send()
    run.t1 = now
    run.counters = {"images": len(answers), "batches": b.n_batches - n_batches0}
    run.attempted = len(answers) + len(b.waiting)
    run.failed = len(b.waiting)
    st["answers"] = answers


def free(run) -> None:
    for k in ("batcher", "params"):
        run.state.pop(k, None)


def _reference(run, rnd=None) -> np.ndarray:
    """The reference's logits for every pool image, in blocks."""
    w = ref_cnn.weights(run.cfg, run.seed, run.device)
    pool = run.state["pool"]
    out = []
    for i in range(0, len(pool), 32):
        x = torch.from_numpy(pool[i:i + 32]).to(run.device)
        out.append(ref_cnn.forward(run.cfg, w, x, rnd).cpu().numpy())
    return np.concatenate(out)


def rel_err(answers: list, ref: np.ndarray) -> float:
    """The largest, over answers, of ``max |answer − reference|`` over the
    answer's logits, relative to the reference's largest magnitude."""
    worst = 0.0
    scale = np.abs(ref).max(axis=1)
    for s in range(0, len(answers), 4096):
        chunk = answers[s:s + 4096]
        idx = np.array([i for i, _ in chunk])
        got = np.stack([a for _, a in chunk])
        worst = max(worst, float((np.abs(got - ref[idx]).max(axis=1) / scale[idx]).max()))
    return worst


def check(run) -> dict:
    lim = run.limits
    answers = run.state["answers"]
    ref = _reference(run)
    # a network whose ReLUs all close would answer every image with its bias
    print(f"[portbench] check: the reference's logits spread {float(ref.std(axis=0).mean()):.4g}"
          f" across images against {float(np.abs(ref).max()):.4g} at most", file=sys.stderr)
    err = rel_err(answers, ref) if answers else float("inf")
    return {"logit_err": {"value": err, "limit": lim["logit_err"]},
            "missing": {"value": run.failed, "limit": 0}}


def control(run, rounding) -> float:
    """The control's reading: the reference at ``rounding`` put in the
    program's place, its answers for the pool held against the reference."""
    ref = _reference(run)
    low = _reference(run, rounding)
    return rel_err(list(enumerate(low)), ref)

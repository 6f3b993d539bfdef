"""LM serving through the port's ``Engine``, in a closed or an open loop.

Closed (``"loop": "closed"``): ``clients`` clients each send a request and
send their next when the last token of the one before comes.  Open
(``"loop": "open"``): requests are due at stratified exponential gaps
(``traffic.arrivals``) and are sent when due, however far behind the engine
is.  Prompt and output lengths follow the mix's distributions, one fixed
trace for every seed; the seed draws the token ids.  Time to first token
is timed from when a request was due to the end of the engine tick that
produced its first token.

After the window the engine runs on, with no new requests, until every
request due in the window has its first token.  The check runs the
reference over a sample of finished requests drawn from the seed, the one
with the most tokens among them, each prompt with its served tokens, and
reads by how much each served (greedy) token's logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
from collections import deque

import numpy as np
import torch

from portbench import traffic
from portbench.reference import draw
from portbench.reference import lm as ref_lm

__all__ = ["port_config", "port_params", "setup", "window", "free", "check", "gaps",
           "DRAIN_S"]

DRAIN_S = 120.0  # after the window, how long the engine may run to first tokens


def port_config(cfg: dict):
    """The configuration file as the port's ``ArchConfig``: the port's
    registry entry with every size of the file put in."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PASMQuant

    return dataclasses.replace(
        get_config(cfg["port"]), n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab=cfg["vocab"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["norm_eps"], act="swiglu", tie_embeddings=False,
        quant=PASMQuant(enabled=True, bins=cfg["bins"], impl=cfg["impl"],
                        kv_bits=cfg["kv_bits"]))


def _shared(idx, cb):
    from repro_torch.core.params import PasmParams

    p = PasmParams.shared(idx, cb)
    return p.pack() if p.bins <= 16 else p


def port_params(cfg: dict, seed: int, device, embed_dtype=torch.bfloat16) -> dict:
    """The drawn weights in the port's tree: every matrix a packed
    ``PasmParams``, norms as the port's ``1 + scale`` scales, the embedding
    in ``embed_dtype``."""
    layers = []
    for i in range(cfg["n_layers"]):
        d = draw.lm_layer(seed, i, cfg, device)
        layers.append({
            "attn_norm": d["attn_norm"] - 1.0, "ffn_norm": d["ffn_norm"] - 1.0,
            "attn": {k: _shared(*d[k]) for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: _shared(*d[k]) for k in ("w1", "w3", "w2")},
        })
        del d
    return {"embed": draw.lm_embed(seed, cfg, device, embed_dtype), "layers": layers,
            "final_norm": draw.lm_norm(seed, "final_norm", cfg["d_model"], device) - 1.0,
            "lm_head": _shared(*draw.lm_head(seed, cfg, device))}


def _engine(run, pcfg, params):
    """The port's ``Engine``, its model calls in ``portbench`` spans: a
    prefill span names its request, a decode span the context each live
    slot's query sees."""
    from repro_torch.serve.engine import Engine

    spans = run.spans

    class Traced(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._plans = deque()
            admit = self.sched.admit

            def recording_admit():
                plans = admit()
                self._plans.extend(plans)
                return plans

            self.sched.admit = recording_admit

        def _call(self, key, build, *args):
            kind = key.split(":")[0]
            if kind == "prefill":
                r = self._plans.popleft().req
                attrs = {"uid": r.uid, "n": len(r.prompt), "rows": int(key.split(":")[1])}
            else:
                attrs = {"rows": self.batch,
                         "ctx": [len(r.prompt) + len(r.out) for r in self.live.values()]}
            with spans.span(kind, sync=True, **attrs):
                return super()._call(key, build, *args)

    return Traced(pcfg, params, batch_slots=run.mix["slots"], max_seq=run.mix["max_seq"],
                  clock=time.perf_counter)


def _buckets(mix: dict) -> list:
    from repro_torch.serve.scheduler import pow2_bucket

    levels = [traffic.quantile(mix["prompt_len"], (i + 0.5) / traffic.BLOCK)
              for i in range(traffic.BLOCK)]
    return sorted({pow2_bucket(int(n), hi=mix["max_seq"]) for n in levels})


def setup(run) -> None:
    if run.cuda:
        from repro_torch.kernels import _build

        _build.build()
    cfg, mix = run.cfg, run.mix
    pcfg = port_config(cfg)
    params = port_params(cfg, run.seed, run.device)
    eng = _engine(run, pcfg, params)
    g = traffic.rng(run.seed, "warmup")
    for b in _buckets(mix):  # one prefill per bucket the mix reaches, and decodes
        eng.submit(g.integers(0, cfg["vocab"], size=b - 2, dtype=np.int32), max_new=2)
    eng.run_until_drained(max_ticks=100)
    run.spans.items.clear()
    run.state.update(engine=eng, params=params)


class _Clients:
    """The loop's side of the requests: when each was due, when its first
    token and its last came, and the tokens counted in the window."""

    def __init__(self, run, eng, reqs):
        self.run, self.eng, self.reqs = run, eng, reqs
        self.recs, self.open = [], []
        self.tokens = 0

    def send(self, due: float) -> None:
        prompt, max_new = self.reqs[len(self.recs) % len(self.reqs)]
        r = self.eng.submit(prompt, max_new=max_new)
        rec = {"r": r, "due": due, "first": math.nan, "done": math.nan, "seen": 0,
               "n_prompt": len(prompt)}
        self.recs.append(rec)
        self.open.append(rec)

    def observe(self, now: float) -> list:
        """Marks what the last tick produced; returns the requests it ended."""
        ended = []
        for rec in self.open:
            r = rec["r"]
            n = len(r.out)
            if n > rec["seen"]:
                if rec["seen"] == 0:
                    rec["first"] = now
                    self.tokens += rec["n_prompt"]
                self.tokens += n - rec["seen"]
                rec["seen"] = n
            if r.done or r.failed:
                rec["done"] = now
                ended.append(rec)
        if ended:
            gone = {id(x) for x in ended}
            self.open = [x for x in self.open if id(x) not in gone]
        return ended


def _preroll(eng, cl, clients: int, ticks: int, clock) -> None:
    """A closed loop's pre-roll, counted in engine ticks, so that every run
    makes the same engine calls in the same order: client ``i`` sends its
    first request before tick ``i * ticks // clients``, and each client its
    next when its last ends."""
    joins = deque(i * ticks // clients for i in range(clients))
    for tick in range(ticks):
        while joins and joins[0] <= tick:
            joins.popleft()
            cl.send(clock())
        eng.step()
        now = clock()
        for _ in cl.observe(now):
            cl.send(now)


def window(run) -> None:
    """The loop, after a pre-roll counted as set-up.  A closed loop's
    clients join one by one over ``preroll_ticks`` engine ticks, so the
    window opens on a loop in its steady state, in the same state in every
    run; an open loop's arrivals begin ``preroll_s`` before the window.
    Only requests due in the window are timed."""
    mix, eng = run.mix, run.state["engine"]
    clock = time.perf_counter
    closed = mix["loop"] == "closed"
    if closed:
        reqs = traffic.lm_requests(mix, run.seed, mix["n_requests"], run.cfg["vocab"])
        cl = _Clients(run, eng, reqs)
        _preroll(eng, cl, mix["clients"], int(mix["preroll_ticks"]), clock)
        preroll, due = 0.0, np.zeros(0)  # from here clients send when answered
        start = clock()
    else:
        preroll = float(mix.get("preroll_s", 0.0))
        start = clock()
        due = start + traffic.arrivals(mix, preroll + run.seconds)
        reqs = traffic.lm_requests(mix, run.seed, len(due), run.cfg["vocab"])
        cl = _Clients(run, eng, reqs)
    late = []
    t_end = t_last = math.inf
    k = 0
    while True:
        now = clock()
        if math.isnan(run.t0) and now >= start + preroll:
            run.start_window()
            occ0 = (eng.metrics._occ_sum, eng.metrics._occ_ticks)
            tok0 = cl.tokens
            t_end = run.t0 + run.seconds
            now = run.t0
        with run.spans.span("submit"):
            while k < len(due) and due[k] <= min(now, t_end):
                cl.send(float(due[k]))
                if due[k] >= run.t0:  # how late the generator sent it
                    late.append(now - due[k])
                k += 1
        if now >= t_end:
            break
        run.profile_tick(now)
        if eng.busy:
            t_last = now
            with run.spans.span("step"):
                eng.step()
            now = clock()
            ended = cl.observe(now)
            if closed and now < t_end:
                for _ in ended:
                    cl.send(now)
        else:
            nxt = min(float(due[k]) if k < len(due) else math.inf, t_end)
            time.sleep(max(0.0, min(nxt, start + preroll) - now if math.isnan(run.t0)
                           else nxt - now))
    run.t1 = now
    run.counters = {"tokens": cl.tokens - tok0, "requests": len(cl.recs),
                    "occ_sum": eng.metrics._occ_sum - occ0[0],
                    "occ_ticks": eng.metrics._occ_ticks - occ0[1],
                    "queue_at_close": len(eng.sched.waiting),
                    "last_step_before_close_ms": 1e3 * (t_end - t_last)}
    if late:
        run.counters["late_max_ms"] = 1e3 * float(max(late))
    run.profile_stop()
    t_stop = clock() + DRAIN_S
    while any(math.isnan(x["first"]) and not x["r"].failed for x in cl.open) and eng.busy:
        if clock() > t_stop:
            break
        eng.step()
        cl.observe(clock())
    prefills = {s[3]["uid"]: s[1] for s in run.spans.items if s[0] == "prefill"}
    run.requests = [{"due": x["due"], "first": x["first"], "done": x["done"],
                     "failed": bool(x["r"].failed) or math.isnan(x["first"]),
                     "admit": prefills.get(x["r"].uid, math.nan),
                     "n_prompt": x["n_prompt"]} for x in cl.recs if x["due"] >= run.t0]
    run.attempted = len(run.requests)
    run.failed = sum(x["failed"] for x in run.requests)
    run.state["served"] = [(x["r"].prompt, list(x["r"].out)) for x in cl.recs
                           if x["r"].done]


def free(run) -> None:
    for k in ("engine", "params"):
        run.state.pop(k, None)


def sample(run) -> list:
    """The requests the check reads: the finished one with the most tokens,
    and ``check_requests − 1`` more drawn from the seed."""
    served = run.state["served"]
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i][0]) + len(served[i][1]))
    rest = [i for i in range(len(served)) if i != longest]
    g = traffic.rng(run.seed, "check")
    pick = g.permutation(len(rest))[:run.mix["check_requests"] - 1]
    return [served[longest]] + [served[rest[i]] for i in sorted(pick)]


def _logits(run, picked, rnd=None) -> list:
    seqs = [torch.from_numpy(np.concatenate([p, np.asarray(o[:-1], np.int32)])) for p, o in picked]
    pos = [torch.arange(len(p) - 1, len(p) - 1 + len(o)) for p, o in picked]
    return ref_lm.logits_at(run.cfg, run.seed, seqs, pos, run.device, rnd)


def gaps(z: list, tokens: list, log=None) -> float:
    """The widest gap by which a token's logit lies below the best logit at
    its position, over every position of every sequence."""
    worst = 0.0
    for zi, t in zip(z, tokens):
        t = torch.as_tensor(t, device=zi.device).long()
        g = zi.max(-1).values - zi.gather(1, t[:, None])[:, 0]
        worst = max(worst, float(g.max()))
        if log is not None:
            i = int(g.argmax())
            log(f"{len(t)} tokens: widest gap {float(g[i]):.6g} at token {i} (served "
                f"{int(t[i])}, reference's best {int(zi[i].argmax())}); gaps over 0: "
                f"{int((g > 0).sum())}")
    return worst


def check(run) -> dict:
    picked = sample(run)
    log = lambda m: print(f"[portbench] check: {m}", file=sys.stderr, flush=True)  # noqa: E731
    for p, o in picked:
        log(f"request of {len(p)} prompt tokens and {len(o)} served")
    gap = gaps(_logits(run, picked), [o for _, o in picked], log) if picked else math.inf
    return {"token_gap": {"value": gap, "limit": run.limits["token_gap"]},
            "missing": {"value": run.failed, "limit": 0}}


def control(run, rounding) -> float:
    """The control's reading: at each position of the same prompts and
    served tokens, the gap of the token the lower precision puts first."""
    picked = sample(run)
    z = _logits(run, picked)
    low = _logits(run, picked, rounding)
    return gaps(z, [zl.argmax(-1) for zl in low])

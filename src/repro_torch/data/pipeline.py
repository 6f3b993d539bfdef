"""Data pipeline: deterministic synthetic LM stream + file-backed token shards.

Port of ``repro.data.pipeline``.  Batch ``i`` is a pure function of
(seed, step, shard), so a restart resumes mid-epoch without replay logs and
re-sharding (N → M hosts) re-partitions the same global stream.

``jax.random``'s bits cannot be drawn without JAX, so the synthetic streams
draw their own from a ``torch.Generator`` seeded from ``(seed, step,
shard)``: the same laws (a Zipf-ish token model with a learnable bigram
signal; images whose labels carry a planted linear signal), other
numbers.  The token file is the JAX package's format and
:class:`TokenFileDataset` picks its rows with the same numpy generator, so
the two packages read the same bytes for a step.

Input validation is typed (:class:`DataValidationError`), and a transient
``OSError`` during a file-backed read retries with capped exponential
backoff (:func:`retry_io`).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "DataConfig",
    "DataValidationError",
    "retry_io",
    "synthetic_batch",
    "synthetic_image_batch",
    "batch_iterator",
    "TokenFileDataset",
    "write_token_file",
]


class DataValidationError(ValueError):
    """Typed rejection of an invalid data configuration or source: an
    indivisible shard split, or an empty/truncated token file."""


def retry_io(
    fn: Callable,
    *,
    retries: int = 3,
    backoff_s: float = 0.05,
    cap_s: float = 1.0,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``fn()`` retrying transient ``OSError`` s with capped exponential
    backoff (``backoff_s · 2^(attempt-1)``, capped at ``cap_s``).  The final
    attempt's exception surfaces unwrapped.  ``sleep`` is injectable so
    tests pin the schedule with zero wall clock."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = min(backoff_s * (2 ** attempt), cap_s)
            warnings.warn(
                f"transient I/O error (attempt {attempt + 1}/{retries + 1}), "
                f"retrying in {delay:.3g}s: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
            sleep(delay)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    shard_index: int = 0
    n_shards: int = 1
    path: Optional[str] = None  # file-backed when set

    def __post_init__(self):
        if self.n_shards < 1 or self.global_batch < 1:
            raise DataValidationError(
                f"need n_shards >= 1 and global_batch >= 1, got "
                f"n_shards={self.n_shards} global_batch={self.global_batch}"
            )
        if self.global_batch % self.n_shards:
            raise DataValidationError(
                f"global_batch={self.global_batch} must divide evenly over "
                f"n_shards={self.n_shards} (per-shard batch would be ragged)"
            )
        if not (0 <= self.shard_index < self.n_shards):
            raise DataValidationError(
                f"shard_index={self.shard_index} out of range for "
                f"n_shards={self.n_shards}"
            )


def _step_generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from an integer tuple such as
    ``(seed, step, shard)``: distinct tuples give independent streams."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def _markov_tokens(gen: torch.Generator, batch: int, seq_len: int,
                   vocab: int) -> torch.Tensor:
    """Zipf marginal + short-range structure: t ~ f(t-1) with noise."""
    u = torch.rand((batch, seq_len), generator=gen).clamp(min=1e-6)
    zipf = torch.clamp((u ** -0.9 - 1.0).to(torch.int32), 0, vocab - 1)
    # with p=0.5 the next token is a fixed affine map of the previous one —
    # a learnable bigram signal
    follow = torch.rand((batch, seq_len), generator=gen) < 0.5
    mapped = (torch.roll(zipf, 1, dims=1) * 31 + 7) % vocab
    return torch.where(follow, mapped, zipf).to(torch.int32)


def synthetic_batch(cfg: DataConfig, step: int, *, device=None) -> dict:
    """Pure function of (seed, step, shard) → {tokens, labels} int32 on
    ``device`` (default the card)."""
    per_shard = cfg.global_batch // cfg.n_shards
    gen = _step_generator(cfg.seed, step, cfg.shard_index)
    toks = _markov_tokens(gen, per_shard, cfg.seq_len + 1, cfg.vocab)
    toks = toks.to(resolve_device(device))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def synthetic_image_batch(
    cfg: DataConfig, step: int, *, chw: tuple, classes: int, noise: float = 0.25,
    device=None,
) -> dict:
    """Step-addressed image classification batch for the CNN QAT loop:
    pure function of (seed, step, shard) → {images (B, C, H, W) f32,
    labels (B,) int64} on ``device`` (default the card).  Labels carry a
    learnable planted signal — the class whose fixed random template (drawn
    from ``seed + 1``) correlates best with the image — replaced by a
    uniform class with probability ``noise``."""
    per_shard = cfg.global_batch // cfg.n_shards
    gen = _step_generator(cfg.seed, step, cfg.shard_index)
    images = torch.randn((per_shard,) + tuple(chw), generator=gen)
    probe = torch.randn((classes,) + tuple(chw),
                        generator=torch.Generator().manual_seed(cfg.seed + 1))
    planted = torch.argmax(images.reshape(per_shard, -1) @ probe.reshape(classes, -1).T,
                           dim=-1)
    rand = torch.randint(0, classes, (per_shard,), generator=gen)
    take_noise = torch.rand((per_shard,), generator=gen) < noise
    labels = torch.where(take_noise, rand, planted)
    dev = resolve_device(device)
    return {"images": images.to(dev), "labels": labels.to(dev)}


class TokenFileDataset:
    """Flat binary uint32 token file, memory-mapped, sharded by host.

    Construction validates the source (typed :class:`DataValidationError`
    on an empty/truncated file — fewer tokens than one ``seq_len + 1``
    sequence); :meth:`batch` retries transient ``OSError`` s with capped
    backoff before surfacing them."""

    def __init__(
        self,
        cfg: DataConfig,
        *,
        retries: int = 3,
        backoff_s: float = 0.05,
        cap_s: float = 1.0,
        sleep: Callable[[float], None] = time.sleep,
        fault_hook: Optional[Callable[[int], None]] = None,
        device=None,
    ):
        if not cfg.path:
            raise DataValidationError("TokenFileDataset needs cfg.path")
        self.cfg = cfg
        self.retries = retries
        self.backoff_s = backoff_s
        self.cap_s = cap_s
        self.sleep = sleep
        self.fault_hook = fault_hook  # chaos: train.faults plan.on_data
        self.device = resolve_device(device)
        self.tokens = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.n_seqs = len(self.tokens) // (cfg.seq_len + 1)
        if self.n_seqs == 0:
            raise DataValidationError(
                f"empty/truncated token file {cfg.path}: {len(self.tokens)} "
                f"tokens < one sequence of seq_len+1={cfg.seq_len + 1}"
            )

    def _read_rows(self, step: int) -> np.ndarray:
        """One attempt at the step's row gather (the retried I/O unit)."""
        if self.fault_hook is not None:
            self.fault_hook(step)
        cfg = self.cfg
        per_shard = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng((cfg.seed, step, cfg.shard_index))
        idx = rng.integers(0, self.n_seqs, size=per_shard)
        return np.stack(
            [self.tokens[i * (cfg.seq_len + 1) : (i + 1) * (cfg.seq_len + 1)] for i in idx]
        ).astype(np.int32)

    def batch(self, step: int) -> dict:
        rows = retry_io(
            lambda: self._read_rows(step),
            retries=self.retries,
            backoff_s=self.backoff_s,
            cap_s=self.cap_s,
            sleep=self.sleep,
        )
        rows = torch.from_numpy(rows).to(self.device)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def write_token_file(path: str, tokens: np.ndarray) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tokens.astype(np.uint32).tofile(path)


def batch_iterator(cfg: DataConfig, start_step: int = 0, *,
                   device=None) -> Iterator[dict]:
    ds = TokenFileDataset(cfg, device=device) if cfg.path else None
    step = start_step
    while True:
        yield ds.batch(step) if ds else synthetic_batch(cfg, step, device=device)
        step += 1

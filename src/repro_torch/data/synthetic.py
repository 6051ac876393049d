"""Deterministic synthetic corpus (C4 stand-in for the offline container).

A numpy copy of ``repro.data.synthetic``'s token process, so the port's
prompts are the reference's prompts token for token:

  p=0.55: deterministic bigram successor  succ(t) = (a*t + c) mod V
  p=0.20: copy of the token 8 positions back (induction structure)
  p=0.25: zipfian unigram draw

Batches are a pure function of (seed, split, index), so any host can
compute its shard and a restart resumes from a cursor with no replay
(:class:`ShardedLoader`).  The audio and vision families' batches carry
the reference's deterministic stand-ins for their frontends: ``frames``
(whisper, one d_model embedding a token) and ``patches`` (pixtral,
``num_image_tokens`` vit_dim embeddings from a disjoint token draw),
both looked up in a seeded table (:func:`_stub_embeds`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

SPLITS = {"train": 0, "calib": 1, "valid": 2}


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    p_succ: float = 0.55
    p_copy: float = 0.20


def _succ_params(vocab: int, seed: int) -> tuple[int, int]:
    rng = np.random.default_rng(seed + 7)
    a = int(rng.integers(2, vocab - 1)) | 1   # odd -> full cycle for pow2 V
    c = int(rng.integers(1, vocab - 1))
    return a, c


def sample_tokens(cfg: CorpusConfig, split: str, index: int,
                  batch: int, seq: int) -> np.ndarray:
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + SPLITS[split] * 7919 + index) % (2 ** 63))
    a, c = _succ_params(cfg.vocab_size, cfg.seed)
    V = cfg.vocab_size
    # zipf over a shuffled id map so frequent ids are spread over the vocab
    ranks = (rng.zipf(cfg.zipf_a, size=(batch, seq)) - 1) % V
    perm = np.random.default_rng(cfg.seed + 13).permutation(V)
    zipf_draws = perm[ranks]
    u = rng.random((batch, seq))
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = zipf_draws[:, 0]
    for t in range(1, seq):
        succ = (a * toks[:, t - 1] + c) % V
        copy = toks[:, max(t - 8, 0)]
        toks[:, t] = np.where(
            u[:, t] < cfg.p_succ, succ,
            np.where(u[:, t] < cfg.p_succ + cfg.p_copy, copy,
                     zipf_draws[:, t]))
    return toks.astype(np.int32)


def _stub_embeds(tokens: np.ndarray, dim: int, seed: int) -> np.ndarray:
    """Deterministic frame/patch embedding stub derived from token ids:
    rows of a seeded (257, dim) f32 table."""
    rng = np.random.default_rng(seed + 29)
    table = rng.standard_normal((257, dim)).astype(np.float32) * 0.5
    return table[tokens % 257]


def batches_for(model_cfg, *, n: int, batch: int, seq: int, split: str,
                seed: int = 0, start: int = 0) -> list[dict]:
    """``n`` batches: ``tokens`` (batch, seq) numpy int32, and for the
    audio family ``frames`` (batch, seq, d_model) f32 (the encoder's input
    has the prompt's length, as the reference's), for the vision family
    ``patches`` (batch, num_image_tokens, vit_dim) f32."""
    ccfg = CorpusConfig(vocab_size=model_cfg.vocab_size, seed=seed)
    out = []
    for i in range(start, start + n):
        toks = sample_tokens(ccfg, split, i, batch, seq)
        b = {"tokens": toks}
        if model_cfg.family == "audio":
            b["frames"] = _stub_embeds(toks, model_cfg.d_model, seed)
        if model_cfg.family == "vlm":
            img = sample_tokens(ccfg, split, i + 100_000, batch,
                                model_cfg.num_image_tokens)
            b["patches"] = _stub_embeds(img, model_cfg.vit_dim, seed)
        out.append(b)
    return out


@dataclasses.dataclass
class DataCursor:
    """Checkpointable loader state: (split, next_index)."""
    split: str = "train"
    index: int = 0


class ShardedLoader:
    """Per-host loader: host h of H reads batch rows [h*b/H, (h+1)*b/H) of
    the global batch at the cursor, then advances it.  Yields numpy
    batches, as :func:`batches_for` does."""

    def __init__(self, model_cfg, *, global_batch: int, seq: int,
                 split: str = "train", seed: int = 0, host_id: int = 0,
                 num_hosts: int = 1, cursor: DataCursor | None = None):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} is not a multiple "
                             f"of num_hosts {num_hosts}")
        self.model_cfg = model_cfg
        self.global_batch = global_batch
        self.seq = seq
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.cursor = cursor or DataCursor(split=split)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        i = self.cursor.index
        self.cursor.index += 1
        full = batches_for(self.model_cfg, n=1, batch=self.global_batch,
                           seq=self.seq, split=self.cursor.split,
                           seed=self.seed, start=i)[0]
        per = self.global_batch // self.num_hosts
        lo = self.host_id * per
        return {k: v[lo:lo + per] for k, v in full.items()}

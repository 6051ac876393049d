"""Deterministic synthetic corpus (C4 stand-in for the offline container).

A numpy copy of ``repro.data.synthetic``'s token process, so the port's
prompts are the reference's prompts token for token:

  p=0.55: deterministic bigram successor  succ(t) = (a*t + c) mod V
  p=0.20: copy of the token 8 positions back (induction structure)
  p=0.25: zipfian unigram draw

Batches are a pure function of (seed, split, index).  Only the text
families are covered: the frame/patch stubs of the audio and vision
families come with those families.
"""
from __future__ import annotations

import dataclasses

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


def batches_for(model_cfg, *, n: int, batch: int, seq: int, split: str,
                seed: int = 0, start: int = 0) -> list[dict]:
    """``n`` token batches of shape (batch, seq), as numpy int32."""
    if model_cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{model_cfg.family} batches need frame/patch stubs, which this "
            "package does not port yet")
    ccfg = CorpusConfig(vocab_size=model_cfg.vocab_size, seed=seed)
    return [{"tokens": sample_tokens(ccfg, split, i, batch, seq)}
            for i in range(start, start + n)]

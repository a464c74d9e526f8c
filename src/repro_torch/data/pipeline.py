"""Deterministic synthetic-token data pipeline, the counterpart of
``repro.data.pipeline``, token for token.

batch(step) is a pure function of (seed, step, shard): a restart resumes
mid-stream with nothing lost or repeated, and a re-sharded fleet recomputes
its slice of the same global batch. The tokens follow an order-2 Markov
chain over the vocab, t_{i+1} = (31 t_i + 17 t_{i-1} + noise) mod vocab,
with its two starting tokens and its noise drawn as the reference draws
them: ``jax.random`` over the threefry2x32 generator in its partitionable
form (jax 0.9.0's default, ``jax_threefry_partitionable``), here on torch
integers. A key is an int64 tensor of two uint32 words; every uint32 sum,
product and shift is carried in int64 and masked to 32 bits.
"""
from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_I64 = torch.int64
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


# ------------------------------------------------------------ threefry2x32
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under ``key`` (2,); returns the two output words, each x0's shape."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31): the words
    (seed >> 32, seed & 0xFFFFFFFF)."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=_I64)


def _counters(n: int):
    """The (hi, lo) words of the counters 0 .. n - 1."""
    idx = torch.arange(n, dtype=_I64)
    return idx >> 32, idx & _M32


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter (0, data)."""
    y0, y1 = threefry2x32(key, torch.tensor([0], dtype=_I64),
                          torch.tensor([data & _M32], dtype=_I64))
    return torch.cat([y0, y1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key i is the hash of counter i;
    returns (num, 2)."""
    y0, y1 = threefry2x32(key, *_counters(num))
    return torch.stack([y0, y1], dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (partitionable): the two words of the
    hash of each element's row-major index, xor-ed."""
    n = 1
    for d in shape:
        n *= d
    y0, y1 = threefry2x32(key, *_counters(n))
    return (y0 ^ y1).reshape(shape)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` to int32 (its two-draw construction): 32
    higher and 32 lower bits from the two halves of ``split(key)``, reduced
    mod the span as a 64-bit value, ``(hi % span) * (2**32 % span) + lo %
    span``, in uint32 arithmetic."""
    span = maxval - minval if maxval > minval else 1
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    off = (((hi % span) * mult) & _M32) + lo % span
    return (minval + (off & _M32) % span).to(torch.int32)


# ---------------------------------------------------------------- batches
def _fold(seed: int, *xs: int) -> torch.Tensor:
    key = PRNGKey(seed)
    for x in xs:
        key = fold_in(key, x)
    return key


def global_batch_at(cfg: DataConfig, step: int) -> torch.Tensor:
    """The full (global_batch, seq_len + 1) int32 token block of one step,
    on the CPU."""
    key = _fold(cfg.seed, step)
    b, s, v = cfg.global_batch, cfg.seq_len + 1, cfg.vocab
    k1, k2, _k3 = split(key, 3)
    t0 = randint(k1, (b, 2), 0, v).long()
    noise = randint(k2, (b, s), 0, 7).long()
    t1, t2 = t0[:, 0], t0[:, 1]
    toks = []
    for i in range(s):
        t1, t2 = t2, (t1 * 31 + t2 * 17 + noise[:, i]) % v
        toks.append(t2)
    return torch.stack(toks, dim=1).to(torch.int32)


def batch_for_shard(cfg: DataConfig, step: int, shard: int,
                    n_shards: int) -> dict:
    """This shard's slice: {tokens, targets} of (global_batch / n_shards,
    seq_len), the targets the tokens shifted by one."""
    assert cfg.global_batch % n_shards == 0
    per = cfg.global_batch // n_shards
    mine = global_batch_at(cfg, step)[shard * per:(shard + 1) * per]
    return {"tokens": mine[:, :-1], "targets": mine[:, 1:]}


def batch_iterator(cfg: DataConfig, start_step: int = 0, shard: int = 0,
                   n_shards: int = 1):
    step = start_step
    while True:
        yield step, batch_for_shard(cfg, step, shard, n_shards)
        step += 1

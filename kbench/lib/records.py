"""Seeded click-event records, the payloads every traffic kind sends.

Each record is one JSON object of exactly ``width`` bytes::

    {"user":"u48213","ts":1700000000123,"id":"9f86d081884c7d65",
     "type":"click","text":"..."}

- ``user``: one of 100,000 users, drawn Zipf-like (rank ``k`` weighs
  ``1 / k``), with ranks shuffled over the ids so the popular users are
  no run of small numbers;
- ``ts``: a millisecond clock, a few milliseconds apart;
- ``id``: 64 random bits in hex;
- ``type``: one of a small set of event types, weighted;
- ``text``: free text cut from a corpus of words at a random place,
  filling the record to its width.

Records are built into a pool of ``POOL`` distinct records.  The pool
holds the same records for every seed (they depend on the width only),
in an order the seed draws, so every seed gives the program the same
bytes to frame, compress and checksum; traffic sends record ``i`` of a
run as ``pool[i % POOL]``.  The program under test receives only the
bytes, and the reference regenerates them from the seed to judge what
came back.
"""
from __future__ import annotations

import numpy as np

#: distinct records a run cycles through: 64 MB at 1 KB, so a partition
#: of a 64-partition topic repeats a record only every 1,024 of its
#: records (1 MB), far beyond LZ4's 64 KB window
POOL = 65536

USERS = 100_000
TYPES = (b"view", b"click", b"search", b"scroll", b"add_to_cart",
         b"purchase", b"share", b"login")
TYPE_WEIGHTS = (0.34, 0.28, 0.12, 0.1, 0.07, 0.04, 0.03, 0.02)
_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", dtype=np.uint8)
_LETTER_P = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                      4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5,
                      1.0, 0.8, 0.2, 0.2, 0.1, 0.1])


def _corpus(rng: np.random.Generator, nbytes: int) -> bytes:
    """Text of words from a 4,096-word seeded vocabulary, word use
    Zipf-like, at least ``nbytes`` long."""
    lens = np.clip(rng.geometric(0.22, size=4096), 2, 14)
    letters = rng.choice(_LETTERS, size=int(lens.sum()),
                         p=_LETTER_P / _LETTER_P.sum())
    cuts = np.cumsum(lens)[:-1]
    vocab = [w.tobytes() for w in np.split(letters, cuts)]
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    n = int(nbytes / (lens.mean() + 1) * 1.3) + 64
    idx = rng.choice(len(vocab), size=n, p=weights / weights.sum())
    text = b" ".join(vocab[i] for i in idx)
    while len(text) < nbytes:          # the 1.3 margin makes this rare
        text += b" " + text
    return text


def make_pool(seed: int, width: int, n: int = POOL) -> list[bytes]:
    """``n`` distinct records of ``width`` bytes each, in an order drawn
    from ``seed``.  The set of records depends on ``width`` and ``n``
    only, so every seed gives the program the same work (the same bytes
    to frame, compress and checksum) in another order."""
    pool = _base_pool(width, n)
    order = np.random.default_rng([seed, width, n]).permutation(n)
    return [pool[i] for i in order]


def _base_pool(width: int, n: int) -> list[bytes]:
    rng = np.random.default_rng([width, n])
    ranks = np.arange(1, USERS + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks)
    cdf /= cdf[-1]
    user_of_rank = rng.permutation(USERS)
    users = user_of_rank[np.searchsorted(cdf, rng.random(n))]
    ts0 = 1_700_000_000_000 + int(rng.integers(0, 10**10))
    ts = ts0 + np.cumsum(rng.integers(0, 8, size=n))
    ids = rng.integers(0, 2**63, size=n, dtype=np.int64) * 2 + \
        rng.integers(0, 2, size=n, dtype=np.int64)
    types = rng.choice(len(TYPES), size=n, p=TYPE_WEIGHTS)
    corpus = _corpus(rng, max(1 << 20, n * 64))
    starts = rng.integers(0, len(corpus) - width, size=n)
    out = []
    for i in range(n):
        head = b'{"user":"u%d","ts":%d,"id":"%016x","type":"%s","text":"' % (
            users[i], ts[i], int(ids[i]) & (2**64 - 1), TYPES[types[i]])
        room = width - len(head) - 2
        if room < 1:
            raise ValueError(f"width {width} leaves no room for text")
        s = int(starts[i])
        out.append(head + corpus[s:s + room] + b'"}')
    return out

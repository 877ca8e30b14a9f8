"""Sub-seeds: every draw of a run is keyed by ``--seed`` and a tag, so
the same seed gives the same inputs on every run, whatever the order in
which they are made."""
from __future__ import annotations

import hashlib
import struct


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` (any integer) and the tags."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", int(seed) % (1 << 63)))
    h.update(struct.pack("<q", int(seed) >> 63))
    for t in tags:
        h.update(b"\x00" + str(t).encode())
    return int.from_bytes(h.digest(), "little") >> 1


def generator(seed: int, *tags, device="cpu"):
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and the
    tags."""
    import torch
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def uniform(seed: int, *tags) -> float:
    """A number in [0, 1) from ``seed`` and the tags (host only)."""
    return sub_seed(seed, *tags) / float(1 << 63)

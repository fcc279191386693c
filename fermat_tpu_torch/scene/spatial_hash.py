"""Jittered spatial hashing of shading points (fermat_tpu/scene/spatial_hash.py).

`hash_shading_point` gives each lane's (slot, key): a 32-bit key from the
distance-LOD quantized position and a 16-bucket octahedral normal, jittered
per sample; the slot is key mod table_size. `HashAccumulator` is the
persistent cell table of path-space filtering (sums, weight, owner key):
collisions are detected by the owner key rather than resolved, and a lane
whose slot another key owns falls back to its own estimate.

Keys are uint32 values held in int64 tensors, as in core/rng.py.

The ownership write of `deposit` is a scatter-set with duplicate slots.
JAX's `key.at[s].set(...)` on XLA:CPU keeps the last writer, the highest
lane index; `index_put_` on the card leaves the winner undefined. The port
writes the rule out: the highest lane index per slot by
`scatter_reduce(amax)`, then that lane's value. So the owners are the same
on the CPU and on the card, and JAX's. JAX's write-back is kept: an invalid
lane writes slot 0's old key into slot 0 (`s = where(valid, slot, 0)`), so
a valid lane that hashes to slot 0 loses ownership to any invalid lane after
it. The sums are `index_add_`, in lane order on the CPU and in no fixed
order on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3, oct_encode
from fermat_tpu_torch.core.rng import M32, hash_combine, hash_u32

Tensor = torch.Tensor


def hash_shading_point(pos: Vec3, normal: Vec3, eye: Vec3, base_cell: float,
                       table_size: int, jitter: Tensor = None,
                       lod_scale: float = 64.0) -> Tuple[Tensor, Tensor]:
    """(slot int32, key int64 holding a uint32 >= 1) of each lane's shading
    point (spatial_hash.py:27-65). The cell is base_cell * 2^lod with lod
    the rounded log2 of the eye distance over lod_scale, clipped to
    [-16, 16]; `jitter` in [0, 1) dithers the lattice per sample."""
    dx = pos.x - eye.x
    dy = pos.y - eye.y
    dz = pos.z - eye.z
    dist = torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-12))
    # a true division (a Python divisor on the card is a reciprocal multiply)
    ratio = dist / torch.full_like(dist, lod_scale)
    lod = torch.clamp(torch.round(torch.log2(torch.clamp_min(ratio, 1e-6))), -16, 16)
    cell = base_cell * torch.exp2(lod + 16.0) * 2.0 ** -16  # base * 2^lod
    j = 0.0 if jitter is None else jitter
    q = [torch.floor(c / cell + j).to(torch.int32).to(torch.int64) & M32
         for c in (pos.x, pos.y, pos.z)]
    # 2-bit octahedral normal bucket per axis (16 buckets)
    u, v = oct_encode(normal)
    qn = (torch.clamp(((u * 0.5 + 0.5) * 4).to(torch.int32), 0, 3) * 4
          + torch.clamp(((v * 0.5 + 0.5) * 4).to(torch.int32), 0, 3)).to(torch.int64)
    lod_bits = ((lod.to(torch.int32).to(torch.int64) & M32) << 8) & M32
    key = hash_combine(hash_combine(hash_u32(q[0]), hash_u32(q[1])),
                       hash_combine(hash_u32(q[2]), hash_u32(qn ^ lod_bits)))
    key = torch.clamp_min(key, 1)  # 0 is reserved for "empty"
    return (key % table_size).to(torch.int32), key


class HashAccumulator(NamedTuple):
    """Persistent cell accumulator: sums, weight and owner key (0 = empty)
    of each of the K slots (spatial_hash.py:68-114)."""

    sum_x: Tensor  # (K,) float32
    sum_y: Tensor
    sum_z: Tensor
    weight: Tensor  # (K,) float32
    key: Tensor  # (K,) int64 holding a uint32

    @staticmethod
    def create(table_size: int, device) -> "HashAccumulator":
        z = torch.zeros(table_size, dtype=torch.float32, device=device)
        return HashAccumulator(z, z, z, z, torch.zeros(table_size, dtype=torch.int64,
                                                       device=device))

    @staticmethod
    def from_numpy(sum_x, sum_y, sum_z, weight, key, device) -> "HashAccumulator":
        """From JAX's arrays (float32 sums and weight, uint32 keys)."""
        f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        k = torch.from_numpy(np.asarray(key).astype(np.int64)).to(device)
        return HashAccumulator(f(sum_x), f(sum_y), f(sum_z), f(weight), k)

    def decay(self, factor: float) -> "HashAccumulator":
        """Exponential temporal reuse of the sums and weights."""
        return HashAccumulator(self.sum_x * factor, self.sum_y * factor, self.sum_z * factor,
                               self.weight * factor, self.key)

    def owners(self, slot: Tensor, key: Tensor, valid: Tensor) -> Tensor:
        """The owner keys after the lanes' claims: each slot written takes
        the value of its highest lane (key, or the slot's old key for an
        invalid lane, which writes slot 0)."""
        s = torch.where(valid, slot, 0).long()
        val = torch.where(valid, key, self.key[s])
        lane = torch.arange(s.shape[0], dtype=torch.int64, device=s.device)
        win = torch.full_like(self.key, -1).scatter_reduce_(0, s, lane, "amax")
        return torch.where(win >= 0, val[win.clamp_min(0)], self.key)

    def deposit(self, slot: Tensor, key: Tensor, vx: Tensor, vy: Tensor, vz: Tensor,
                valid: Tensor) -> "HashAccumulator":
        """Claim the lanes' slots (last writer), then scatter-add the
        deposits of the lanes whose slot their key owns; the others are
        dropped."""
        new_key = self.owners(slot, key, valid)
        own = valid & (new_key[slot.long()] == key)
        idx = torch.where(own, slot, 0).long()
        add = lambda acc, v: acc.clone().index_add_(0, idx, torch.where(own, v, 0.0))
        return HashAccumulator(add(self.sum_x, vx), add(self.sum_y, vy), add(self.sum_z, vz),
                               add(self.weight, own.to(torch.float32)), new_key)

    def lookup(self, slot: Tensor, key: Tensor):
        """(mean Vec3, hit mask): the cell average where the cell belongs to
        key and holds weight."""
        s = slot.long()
        w = self.weight[s]
        ok = (self.key[s] == key) & (w > 0.0)
        inv = 1.0 / torch.clamp_min(w, 1e-8)
        return Vec3(self.sum_x[s] * inv, self.sum_y[s] * inv, self.sum_z[s] * inv), ok

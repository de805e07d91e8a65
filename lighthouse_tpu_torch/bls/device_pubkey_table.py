"""Device-resident decompressed validator pubkey table.

The port of `lighthouse_tpu/bls/device_pubkey_table.py`: decompression and
packing happen once per validator at registration; a signature batch then
ships (S, K) int32 row indices and the device gathers the affine keys. The
rows are canonical Montgomery kernel words, x and y tensors of shape
(count + 1, 1, 12) on the table's device; row 0 is zero (masked lanes
gather a harmless (0, 0)) and validator i lives at row i + 1.

Registering keys tags each `PublicKey` with its validator index and this
table, which is how the gpu backend recognises an indexed batch.

A key of no validator -- the canary's valid sentinel, which rides every
canaried shared batch -- is registered as an extra row (`extra`): extra
rows follow the validator rows, and a batch names extra j by the index
-2 - j, resolved to its row when it is gathered, so appending validators
never moves what a marshalled batch points at.
"""

import threading

import numpy as np
import torch

from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.ops import field as fd


class DevicePubkeyTable:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._x_np = np.zeros((1, 1, fd.NW), dtype=np.int32)
        self._y_np = np.zeros((1, 1, fd.NW), dtype=np.int32)
        self._rows = None
        self.count = 0  # validator rows (row 0 excluded)
        self._ex_x = np.zeros((0, 1, fd.NW), dtype=np.int32)
        self._ex_y = np.zeros((0, 1, fd.NW), dtype=np.int32)
        self._extras: dict = {}  # compressed key -> its tagged copy
        self._lock = threading.Lock()

    @classmethod
    def from_jax_rows(cls, x_np, y_np, count: int, device="cuda"):
        """A table from the JAX table's host rows (capacity, 1, 33) in
        Montgomery limbs, same row convention; rows past `count` drop."""
        t = cls(device)
        t._x_np = fd.from_jax_bundle(np.asarray(x_np)[: count + 1])
        t._y_np = fd.from_jax_bundle(np.asarray(y_np)[: count + 1])
        t.count = count
        return t

    def tag(self, pubkeys, first: int = 0) -> None:
        """Mark `PublicKey`s as validators first, first + 1, ... of this
        table, whose rows are already present (`from_jax_rows`)."""
        if first < 0 or first + len(pubkeys) > self.count:
            raise ValueError(f"validators {first}..{first + len(pubkeys) - 1} not in the table")
        for i, p in enumerate(pubkeys):
            p.validator_index = first + i
            p.table = self

    def append(self, pubkeys) -> None:
        """Register `PublicKey`s (once per validator) as the next indices."""
        if not pubkeys:
            return
        affs = [G1_GROUP.to_affine(p.point) for p in pubkeys]
        xs = fd.mont_words([a[0] for a in affs])[:, None, :]
        ys = fd.mont_words([a[1] for a in affs])[:, None, :]
        with self._lock:
            first = self.count
            self._x_np = np.concatenate([self._x_np, xs])
            self._y_np = np.concatenate([self._y_np, ys])
            self.count += len(pubkeys)
            self._rows = None  # uploaded again on the next rows()
        self.tag(pubkeys, first)

    def extra(self, pubkey):
        """A copy of `pubkey`, a key of no validator, tagged with this
        table's extra row for it (registered once per key): a batch whose
        other keys lie in this table keeps the table path with it."""
        from lighthouse_tpu_torch.bls.api import PublicKey

        key = pubkey.to_bytes()
        with self._lock:
            hit = self._extras.get(key)
            if hit is None:
                x, y = G1_GROUP.to_affine(pubkey.point)
                self._ex_x = np.concatenate([self._ex_x, fd.mont_words([x])[:, None, :]])
                self._ex_y = np.concatenate([self._ex_y, fd.mont_words([y])[:, None, :]])
                hit = PublicKey(pubkey.point, key)
                hit.validator_index = -2 - len(self._extras)
                hit.table = self
                self._extras[key] = hit
                self._rows = None
        return hit

    def _upload(self):
        """(x, y, first extra row), the rows on the device, uploaded again
        after any registration."""
        with self._lock:
            if self._rows is None:
                self._rows = (
                    torch.as_tensor(np.concatenate([self._x_np, self._ex_x]), device=self.device),
                    torch.as_tensor(np.concatenate([self._y_np, self._ex_y]), device=self.device),
                    len(self._x_np),
                )
            return self._rows

    def rows(self):
        """(x, y) device tensors (count + 1 + extras, 1, 12)."""
        return self._upload()[:2]

    @staticmethod
    def gather_indices(validator_indices) -> np.ndarray:
        """Validator indices -> row indices (-1, a masked lane, -> row 0;
        an extra's index, -2 - j, is kept for `gather`)."""
        idx = np.asarray(validator_indices, dtype=np.int32)
        return np.where(idx >= 0, idx + 1, np.where(idx == -1, 0, idx)).astype(np.int32)

    def gather(self, rows_idx):
        """(...) row indices -> ((..., 1, 12), (..., 1, 12)) on the device."""
        x, y, first_extra = self._upload()
        idx = torch.as_tensor(rows_idx, device=self.device, dtype=torch.int64)
        flat = idx.reshape(-1)
        flat = torch.where(flat < 0, first_extra - 2 - flat, flat)
        shape = tuple(idx.shape) + (1, fd.NW)
        return x.index_select(0, flat).reshape(shape), y.index_select(0, flat).reshape(shape)

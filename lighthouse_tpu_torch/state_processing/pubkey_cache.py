"""Decompressed validator pubkey cache.

The port of `lighthouse_tpu/state_processing/pubkey_cache.py` (role of the
reference client's `ValidatorPubkeyCache`,
beacon_node/beacon_chain/src/validator_pubkey_cache.rs:9-24): pubkey
decompression is expensive; do it once per validator and reuse the key in
every signature-set build.

Every cached key is registered in the cache's `DevicePubkeyTable` as it is
imported, which tags it with its validator index and the table. So a
batch built from the cache's keys ships table rows, not points, from its
first call on: `gpu_backend._table_for` finds the one table. The table
lives on the cache's `device`, "cuda" unless the caller asks for another.
"""

from lighthouse_tpu_torch import bls
from lighthouse_tpu_torch.bls.device_pubkey_table import DevicePubkeyTable


class PubkeyCache:
    def __init__(self, device="cuda"):
        self._by_index: list[bls.PublicKey] = []
        self._by_bytes: dict[bytes, int] = {}
        self._table = DevicePubkeyTable(device)

    def import_new(self, state, decoded=None):
        """Pick up any validators appended since the last import.

        `decoded`, when given, holds those validators' keys already as
        `PublicKey`s (built from their secret keys, say), which saves the
        decompression and subgroup check of each; each must encode to the
        state's pubkey bytes."""
        start = len(self._by_index)
        new_bytes = [bytes(state.validators[i].pubkey) for i in range(start, len(state.validators))]
        if decoded is None:
            keys = [bls.PublicKey.from_bytes(b) for b in new_bytes]
        else:
            keys = list(decoded)
            if len(keys) != len(new_bytes) or any(
                k.to_bytes() != b for k, b in zip(keys, new_bytes)
            ):
                raise ValueError("decoded keys differ from the state's new validators")
        for i, (pk, pk_bytes) in enumerate(zip(keys, new_bytes)):
            self._by_bytes[pk_bytes] = start + i
        self._by_index.extend(keys)
        self._table.append(keys)  # tags each key with its index and the table

    def device_table(self) -> DevicePubkeyTable:
        """The table of every cached key, on the cache's device."""
        return self._table

    def get(self, index: int) -> bls.PublicKey:
        return self._by_index[index]

    def get_by_bytes(self, pk_bytes: bytes) -> bls.PublicKey:
        return self._by_index[self._by_bytes[bytes(pk_bytes)]]

    def index_of(self, pk_bytes: bytes):
        return self._by_bytes.get(bytes(pk_bytes))

    def __len__(self):
        return len(self._by_index)

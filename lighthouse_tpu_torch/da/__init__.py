"""Data-availability sampling plane (PeerDAS-shaped).

The port of `lighthouse_tpu/da/`. Blob polynomials are Reed-Solomon
extended 2x over a roots-of-unity domain in Fr (`da.erasure`, CUDA kernel
`csrc/rs_extend.cu` through `ops/rs_extend.py`), split into cells whose KZG
multiproofs verify through the same two-pair folded pairing as blob proofs
(`da.cells`, riding `ops/kzg_verify.py` and its kernels), and distributed
as column sidecars over column subnets with per-node custody
(`da.custody`). Any 50% of columns reconstructs every blob.

Layout mirrors the kzg package: host policy and the ref oracles in the
plane modules, device marshalling in `da.gpu_backend`, every device call
through the guarded executor with no failover: a fault reaches the caller
as a `DeviceFaultError`. The backends are "gpu" (the default: the kernels
for `device="cuda"`, their plain versions for `device="cpu"`), "ref" and
"fake".
"""

from lighthouse_tpu_torch.da.domain import CellGeometry, DaError, geometry, geometry_for_spec

__all__ = [
    "CellGeometry",
    "DaError",
    "geometry",
    "geometry_for_spec",
]

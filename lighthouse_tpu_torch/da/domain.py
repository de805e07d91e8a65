"""DA cell geometry: extended evaluation domain + coset structure.

A copy of `lighthouse_tpu/da/domain.py` (host Python; the port keeps its
own).

A blob is a coefficient-form polynomial of n = FIELD_ELEMENTS_PER_BLOB
Fr coefficients (the codebase's documented dev simplification — see
kzg/api.py). Reed-Solomon extension evaluates it at the 2n-th roots of
unity W^0..W^(2n-1) (W = GENERATOR^((r-1)/2n), primitive). Cells are
the multiplicative COSETS of that domain: with m =
FIELD_ELEMENTS_PER_CELL and num_cells = 2n/m, cell k holds the
evaluations at indices {k + num_cells*j : j = 0..m-1}, i.e. the points
W^k * omega^j with omega = W^num_cells a primitive m-th root of unity.

Why cosets and not contiguous ranges: every point x of cell k satisfies
x^m = W^(k*m) =: c_k, so the vanishing polynomial of the whole cell is
the BINOMIAL Z_k(X) = X^m - c_k. That is what makes cell multiproofs
cheap (`da.cells`): computing one is a single synthetic long division,
and the batched verification folds into the exact two-pair pairing
shape of the existing blob-proof device kernel with [tau^m]G2 replacing
[tau]G2. (The consensus spec's bit-reversal permutation achieves the
same coset structure with contiguous indices; we keep natural order and
strided indices — one convention, documented here, used everywhere.)

Any n of the 2n extended evaluations — any num_cells/2 cells —
determine the polynomial (`da.erasure.reconstruct_poly`), which is the
50%-availability reconstruction bound the sampling plane is built on.
"""

import functools

from lighthouse_tpu_torch.crypto.constants import R

# Multiplicative generator of Fr* (standard for BLS12-381's scalar
# field; r - 1 = 2^32 * odd gives 2-adicity 32, far above any blob
# size this repo reaches).
GENERATOR = 7
TWO_ADICITY = 32
assert (R - 1) % (1 << TWO_ADICITY) == 0

BYTES_PER_FIELD_ELEMENT = 32


class DaError(Exception):
    """Loud failure of the DA plane: bad geometry, malformed cells,
    or reconstruction below the 50% availability bound."""


class CellGeometry:
    """Domain description for (n blob elements, m cell elements).
    Build via `geometry()`, which caches per shape: the root-of-unity
    powers are reused by every extension/proof/verification at that
    preset."""

    def __init__(self, blob_elements: int, cell_elements: int):
        n, m = blob_elements, cell_elements
        if n < 1 or (n & (n - 1)):
            raise DaError(f"blob size {n} must be a power of two")
        if m < 1 or (2 * n) % m:
            raise DaError(
                f"cell size {m} must divide the extended domain {2 * n}"
            )
        if 2 * n > (1 << TWO_ADICITY):
            raise DaError(f"extended domain 2*{n} exceeds Fr 2-adicity")
        self.blob_elements = n
        self.cell_elements = m
        self.ext_elements = 2 * n
        self.num_cells = 2 * n // m
        self.blob_bytes = n * BYTES_PER_FIELD_ELEMENT
        self.cell_bytes = m * BYTES_PER_FIELD_ELEMENT
        # primitive 2n-th root of unity
        self.w2n = pow(GENERATOR, (R - 1) // (2 * n), R)
        assert pow(self.w2n, n, R) == R - 1, "w2n not primitive"
        # all 2n domain points, natural order
        self.ext_points = []
        acc = 1
        for _ in range(2 * n):
            self.ext_points.append(acc)
            acc = acc * self.w2n % R

    def cell_indices(self, k: int) -> list:
        """Extended-domain evaluation indices belonging to cell k."""
        if not 0 <= k < self.num_cells:
            raise DaError(f"cell index {k} out of range")
        return [k + self.num_cells * j for j in range(self.cell_elements)]

    def cell_points(self, k: int) -> list:
        return [self.ext_points[i] for i in self.cell_indices(k)]

    def vanishing_const(self, k: int) -> int:
        """c_k with Z_k(X) = X^m - c_k vanishing on cell k's coset:
        every coset point x has x^m = W^(k*m)."""
        if not 0 <= k < self.num_cells:
            raise DaError(f"cell index {k} out of range")
        return pow(self.w2n, k * self.cell_elements, R)


@functools.lru_cache(maxsize=None)
def geometry(blob_elements: int, cell_elements: int) -> CellGeometry:
    return CellGeometry(blob_elements, cell_elements)


def geometry_for_spec(spec) -> CellGeometry:
    """Spec -> geometry, validating the DAS constants cohere (the
    subnet count must tile the column space evenly)."""
    geo = geometry(
        spec.FIELD_ELEMENTS_PER_BLOB, spec.FIELD_ELEMENTS_PER_CELL
    )
    if geo.num_cells != spec.NUMBER_OF_COLUMNS:
        raise DaError(
            f"NUMBER_OF_COLUMNS {spec.NUMBER_OF_COLUMNS} != cells "
            f"{geo.num_cells}"
        )
    if spec.NUMBER_OF_COLUMNS % spec.DATA_COLUMN_SIDECAR_SUBNET_COUNT:
        raise DaError(
            f"{spec.DATA_COLUMN_SIDECAR_SUBNET_COUNT} column subnets "
            f"do not tile {spec.NUMBER_OF_COLUMNS} columns"
        )
    return geo
